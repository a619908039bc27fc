"""PyTorch / CUDA port of the ``repro`` RAGCache package for NVIDIA Hopper.

Mirrors ``repro``'s layout (``configs``, ``core``, ``kernels``, ``kvcache``,
``launch``, ``models``, ``retrieval``, ``serving``) so each module has a
counterpart of the same name.  Imports torch, numpy and the standard library
only: never jax, never a module of ``repro``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
