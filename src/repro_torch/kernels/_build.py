"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Libraries land in ``<repo>/build/kernels`` keyed by a
hash of the sources and flags: an edited source rebuilds, an unchanged one
loads the library already there.  A failed build raises with nvcc's stderr.
Nothing here runs at import; the wrappers call ``load`` at first launch and
``build_all`` builds every source at once, one nvcc process each, and
returns ptxas's report (registers, shared memory, spills) of each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("paged_decode", "paged_prefill", "prefix_attention")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# launcher signatures: pointers and the stream as c_void_p, ints as c_int,
# the softcap and scale as c_float, element strides as c_longlong (see the
# extern "C" functions in csrc/)
ARGTYPES = {
    "paged_decode": [_P] * 10 + [_I] * 10 + [_F, _F, _I, _P],
    "paged_prefill": [_P] * 9 + [_I] * 10 + [_F, _F, _I] + [_L] * 6 + [_P],
    "prefix_attention": [_P] * 4 + [_I] * 8 + [_F, _F, _I] + [_L] * 12
    + [_P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (process or None, temp output, final path)."""
    out = lib_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    """Wait for nvcc; its stderr (ptxas's report), or "" if the library was
    already built."""
    if proc is None:
        return ""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)
    return err


def build_all(names: List[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source in parallel (one nvcc each); ptxas's
    report by source."""
    started = [(n, *_start(n)) for n in names]
    errors, reports = [], {}
    for name, proc, tmp, out in started:
        try:
            reports[name] = _finish(name, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
            for extra in ("error_string", "body"):
                text = getattr(lib, f"{name}_{extra}", None)
                if text is not None:
                    text.argtypes = [ctypes.c_int]
                    text.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def body(name: str, is_bf16: bool) -> str:
    """Which body of ``name``'s library serves a dtype (tensor cores or
    CUDA cores), as the library itself reports it."""
    lib = load(name)
    return getattr(lib, f"{name}_body")(int(is_bf16)).decode()
