"""Paged KV block pool (vLLM-style, paper §2/§5.1: "RAGCache stores the
key-value tensors in non-contiguous memory blocks") — counterpart of
``repro.kvcache.paged``.

The pool owns one (L, n_blocks, block_size, KV / tp, hd) plane pair per
shard of its mesh (one shard on its device without a mesh), on the
shard's device; documents hold block-id lists.  The block allocator, the
block ids and the slot coordinates stay single (they do not depend on
heads), so every scheduler and tree decision is the same at any tp.
Ref-counting lets overlapping knowledge-tree paths share blocks.  Every
write goes into the planes in place (``index_put_``): ``store.k_planes`` /
``store.v_planes`` are never reassigned, so model steps can hold them
across calls.

``DiskSegmentStore`` is the third tier below the host copies: one file per
knowledge-tree node, written once on host->disk demotion.  numpy has no
bfloat16, so a segment is written as raw bytes and its torch dtype and
shape live in the ``DiskSegment`` handle; reading it back is bit-exact.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class OutOfBlocks(RuntimeError):
    pass


class BlockPool:
    """Fixed-capacity block allocator with refcounts."""

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._ref = np.zeros(n_blocks, np.int32)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"need {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            assert self._ref[b] > 0
            self._ref[b] += 1

    def decref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            assert self._ref[b] > 0, f"double free of block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)

    def exclusive(self, blocks: Sequence[int]) -> int:
        """How many of ``blocks`` have refcount 1 — i.e. would actually
        return to the free list if their sole owner dropped them."""
        return int(sum(1 for b in blocks if self._ref[b] == 1))

    def check(self) -> None:
        live = int((self._ref > 0).sum())
        assert live + len(self._free) == self.n_blocks
        assert len(set(self._free)) == len(self._free)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned when it comes from a CUDA device, so the
    promote back is an asynchronous copy."""
    if t.is_cuda:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h
    return t.clone()


class PagedKVStore:
    """Paged storage for per-document KV segments.

    Layout: ``k_planes``/``v_planes`` hold one (L, n_blocks, block_size,
    KV / tp, hd) plane per shard of ``mesh`` on its device
    (``launch/sharding.py::pool_kv_spec``); without a mesh, one whole
    plane on ``device``.  A stored
    segment is (block_ids, n_tokens).  ``put``/``append`` write each
    shard's head slice, ``gather`` returns whole heads on the first
    device.
    """

    def __init__(self, n_layers: int, n_blocks: int, block_size: int,
                 n_kv: int, head_dim: int, dtype=torch.float32,
                 device="cpu", mesh=None):
        self.pool = BlockPool(n_blocks, block_size)
        self.block_size = block_size
        self.devices = ([torch.device(device)] if mesh is None
                        else list(mesh.devices))
        tp = len(self.devices)
        if n_kv % tp:
            raise ValueError(f"{n_kv} KV heads do not split over tp {tp}")
        self.device = self.devices[0]
        self.n_kv = n_kv
        shape = (n_layers, n_blocks, block_size, n_kv // tp, head_dim)
        self.k_planes = [torch.zeros(shape, dtype=dtype, device=d)
                         for d in self.devices]
        self.v_planes = [torch.zeros(shape, dtype=dtype, device=d)
                         for d in self.devices]

    @property
    def tp(self) -> int:
        return len(self.k_planes)

    def bytes_per_token(self) -> int:
        """KV bytes a token takes over all shards (the whole model's)."""
        L, _, _, _, hd = self.k_planes[0].shape
        return int(2 * L * self.n_kv * hd * self.k_planes[0].element_size())

    def _index(self, ids, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64),
                               device=self.device if device is None
                               else device)

    def _shard_segment(self, k_seg, v_seg):
        """Split an incoming (L, 1, T, KV, hd) segment by KV heads the way
        the pool is sharded: one (L, 1, T, KV / tp, hd) piece per shard,
        copied to the shard's device (each device receives exactly its
        head slice, never a whole replica).  Returns (k pieces, v
        pieces)."""
        n = self.n_kv // self.tp
        return tuple(
            [seg[..., i * n:(i + 1) * n, :].to(d, non_blocking=True)
             for i, d in enumerate(self.devices)]
            for seg in (k_seg, v_seg))

    def _heads(self, parts) -> torch.Tensor:
        """The shards' head slices (..., KV / tp, hd) as whole heads on the
        first device."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([t.to(self.device) for t in parts], dim=-2)

    def put(self, k_seg, v_seg, reserve_tokens: int = 0) -> "PagedSegment":
        """k_seg/v_seg: (L, 1, T, KV, hd) contiguous -> paged blocks.

        reserve_tokens: allocate capacity for this many *extra* tokens beyond
        T (the serving runtime's decode step writes appended tokens into the
        reserved tail slots through the request's block table)."""
        T = k_seg.shape[2]
        nb = self.pool.blocks_for_tokens(T + reserve_tokens)
        blocks = self.pool.alloc(nb)
        pad = nb * self.block_size - T
        ks, vs = self._shard_segment(k_seg, v_seg)
        for pieces, planes in ((ks, self.k_planes), (vs, self.v_planes)):
            for src, dst in zip(pieces, planes):
                s = src[:, 0].to(dst.device, dst.dtype, non_blocking=True)
                s = torch.nn.functional.pad(s, (0, 0, 0, 0, 0, pad))
                s = s.reshape(s.shape[0], nb, self.block_size, *s.shape[2:])
                dst.index_copy_(1, self._index(blocks, dst.device), s)
        return PagedSegment(self, blocks, T)

    def append(self, seg: "PagedSegment", k_new, v_new) -> "PagedSegment":
        """Extend an existing segment with more tokens (chunked-prefill
        continuation): fill the partially-used tail slots of the last block,
        then allocate additional blocks for the remainder.

        k_new/v_new: (L, 1, T, KV, hd) contiguous.  Mutates ``seg`` in place
        (blocks list + n_tokens) and returns it.  Raises ``OutOfBlocks``
        (leaving ``seg`` unchanged) if the pool cannot hold the extension.
        """
        T = int(k_new.shape[2])
        if T == 0:
            return seg
        capacity = len(seg.blocks) * self.block_size
        need = (seg.n_tokens + T) - capacity
        if need > 0:
            seg.blocks.extend(self.pool.alloc(self.pool.blocks_for_tokens(need)))
        pos = np.arange(seg.n_tokens, seg.n_tokens + T)
        blk = np.asarray(seg.blocks, np.int64)[pos // self.block_size]
        slot = pos % self.block_size
        ks, vs = self._shard_segment(k_new, v_new)
        for pieces, planes in ((ks, self.k_planes), (vs, self.v_planes)):
            for src, dst in zip(pieces, planes):
                s = src[:, 0].to(dst.device, dst.dtype, non_blocking=True)
                dst[:, self._index(blk, dst.device),
                    self._index(slot, dst.device)] = s
        seg.n_tokens += T
        return seg

    def extend_alloc(self, seg: "PagedSegment",
                     n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Reserve capacity for ``n`` more tokens WITHOUT writing data —
        the paged prefill step scatters KV into the pool in place, so the
        store only needs to hand out the (block, slot) coordinates.

        Mutates ``seg`` (blocks list + n_tokens) and returns int32
        ``(blk, slot)`` arrays of shape (n,) for the new token positions.
        Raises ``OutOfBlocks`` (leaving ``seg`` unchanged — ``alloc`` checks
        capacity before mutating anything) if the pool cannot hold them.
        """
        capacity = len(seg.blocks) * self.block_size
        need = (seg.n_tokens + n) - capacity
        if need > 0:
            seg.blocks.extend(self.pool.alloc(self.pool.blocks_for_tokens(need)))
        pos = np.arange(seg.n_tokens, seg.n_tokens + n)
        blk = np.asarray(seg.blocks, np.int64)[pos // self.block_size]
        slot = pos % self.block_size
        seg.n_tokens += n
        return blk.astype(np.int32), slot.astype(np.int32)

    def gather_shards(self, seg: "PagedSegment"):
        """Paged -> contiguous (L, 1, T, KV / tp, hd) pieces, one per
        shard on its device: (k pieces, v pieces)."""
        out = []
        for planes in (self.k_planes, self.v_planes):
            pieces = []
            for plane in planes:
                t = plane[:, self._index(seg.blocks, plane.device)]
                L, nb, bs, KV, hd = t.shape
                pieces.append(t.reshape(L, nb * bs, KV, hd)
                              [:, :seg.n_tokens][:, None])
            out.append(pieces)
        return out[0], out[1]

    def gather(self, seg: "PagedSegment"):
        """Paged -> contiguous (L, 1, T, KV, hd) tensors, whole heads, on
        the (first) device."""
        ks, vs = self.gather_shards(seg)
        return self._heads(ks), self._heads(vs)

    def read_slots(self, blk, slot):
        """K and V (L, *blk.shape, KV, hd) at the (block, slot)
        coordinates ``blk``/``slot`` (tensors on the first device), whole
        heads on the first device."""
        return tuple(
            self._heads([p[:, blk.to(p.device), slot.to(p.device)]
                         for p in planes])
            for planes in (self.k_planes, self.v_planes))

    def write_slots(self, blk, slot, k, v) -> None:
        """Write K and V (L, *blk.shape, KV, hd), whole heads, at the
        (block, slot) coordinates; each shard takes its head slice."""
        n = self.n_kv // self.tp
        for planes, src in ((self.k_planes, k), (self.v_planes, v)):
            for i, p in enumerate(planes):
                part = src[..., i * n:(i + 1) * n, :]
                p[:, blk.to(p.device), slot.to(p.device)] = part.to(p.device)

    def sync(self) -> None:
        """Wait for the queued work of every CUDA device of the pool."""
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def free(self, seg: "PagedSegment") -> None:
        self.pool.decref(seg.blocks)

    def share(self, seg: "PagedSegment") -> None:
        """Refcount a segment's blocks for an additional reader (e.g. a
        running request's block table pointing at knowledge-tree blocks)."""
        self.pool.incref(seg.blocks)

    def share_blocks(self, blocks: Sequence[int]) -> None:
        """Refcount a raw block list — the counterpart of ``release``."""
        self.pool.incref(blocks)

    def release(self, blocks: Sequence[int]) -> None:
        self.pool.decref(blocks)


@dataclasses.dataclass
class PagedSegment:
    store: PagedKVStore
    blocks: List[int]
    n_tokens: int

    @property
    def n_bytes(self) -> int:
        return len(self.blocks) * self.store.block_size * self.store.bytes_per_token()


# --------------------------------------------------------------------------
# disk tier: one file per knowledge-tree node
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DiskSegment:
    """Handle to one node's on-disk KV: raw bytes of k then v, each of
    ``shape`` (L, 1, T, KV, hd) in ``dtype``.  The file holds no header."""
    store: "DiskSegmentStore"
    path: str
    shape: Tuple[int, ...]          # (L, 1, T, KV, hd)
    dtype: torch.dtype
    n_bytes: int


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """The bytes of a CPU tensor as a uint8 array (works for bfloat16,
    which numpy cannot represent)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


class DiskSegmentStore:
    """mmap-file-per-segment disk tier.

    ``write`` creates the file and flushes it, ``read`` maps it read-only
    and materialises tensor copies, ``delete`` reclaims the file.  Byte
    accounting (``used_bytes``/``n_files``) is exact — the file size is
    2 * T * kv_bytes_per_token, no block padding."""

    def __init__(self, root_dir: str, capacity_bytes: int = 0):
        self.root = root_dir
        self.capacity_bytes = capacity_bytes
        self.used_bytes = 0
        self.n_files = 0
        self._count = itertools.count()
        os.makedirs(root_dir, exist_ok=True)

    def write(self, k: torch.Tensor, v: torch.Tensor) -> DiskSegment:
        """k/v: (L, 1, T, KV, hd) host tensors -> one mmap'd file."""
        kb, vb = _raw_bytes(k.cpu()), _raw_bytes(v.cpu())
        path = os.path.join(self.root, f"seg{next(self._count):08d}.kv")
        mm = np.memmap(path, dtype=np.uint8, mode="w+",
                       shape=(2, kb.size))
        mm[0] = kb
        mm[1] = vb
        mm.flush()
        n_bytes = int(mm.nbytes)
        del mm                          # drop the mapping, keep the file
        self.used_bytes += n_bytes
        self.n_files += 1
        return DiskSegment(self, path, tuple(k.shape), k.dtype, n_bytes)

    def read(self, seg: DiskSegment) -> Tuple[torch.Tensor, torch.Tensor]:
        mm = np.memmap(seg.path, dtype=np.uint8, mode="r",
                       shape=(2, seg.n_bytes // 2))
        out = tuple(torch.from_numpy(np.array(mm[i])).view(seg.dtype)
                    .reshape(seg.shape) for i in range(2))
        del mm
        return out

    def delete(self, seg: DiskSegment) -> None:
        os.remove(seg.path)
        self.used_bytes -= seg.n_bytes
        self.n_files -= 1

    def clear(self) -> None:
        """Best-effort removal of every segment file (shutdown path)."""
        if not os.path.isdir(self.root):
            return                      # already closed
        for name in os.listdir(self.root):
            if name.endswith(".kv"):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
        self.used_bytes = 0
        self.n_files = 0

    def close(self) -> None:
        """clear() plus removal of the (then-empty) segment directory."""
        self.clear()
        try:
            os.rmdir(self.root)
        except OSError:
            pass


def make_disk_store(root_dir: Optional[str],
                    capacity_bytes: int) -> Optional[DiskSegmentStore]:
    """Build the disk tier for a serving engine: a fresh subdirectory under
    ``root_dir`` (or under the system temp dir when None), so two engines
    pointed at the same directory never collide on segment file names.
    None = disabled."""
    if capacity_bytes <= 0:
        return None
    import atexit
    import tempfile
    if root_dir is not None:
        os.makedirs(root_dir, exist_ok=True)
    path = tempfile.mkdtemp(prefix="ragcache-disk-", dir=root_dir)
    store = DiskSegmentStore(path, capacity_bytes)
    # the engine owns no shutdown hook; reclaim the segment files (up to the
    # whole disk budget) and the directory when the process exits
    atexit.register(store.close)
    return store
