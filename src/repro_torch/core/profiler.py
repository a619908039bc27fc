"""Prefill-cost profiler: T(alpha cached, beta non-cached) with bilinear
interpolation — Algorithm 1 lines 6–9 of the paper.

PGDSF needs the *per-non-cached-token* compute cost of a document given how
much of its prefix was cached.  RAGCache profiles the LLM offline over a grid
of (alpha, beta) and interpolates.  Two sources feed the same table format:

  * measured: timing the real JAX model on this host (tiny models), and
  * analytic: a hardware profile (A10G / H800 / TPU v5e) for the simulator.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple


@dataclasses.dataclass
class HardwareProfile:
    """Analytic serving-cost model for one accelerator setup."""
    name: str
    flops_per_s: float           # effective prefill FLOP/s (already derated)
    hbm_bytes_per_s: float       # device memory bandwidth
    pcie_bytes_per_s: float      # host<->device link (the paper's PCIe 4.0x16)
    model_params: float          # active parameters
    kv_bytes_per_token: float    # paper Table 1 column
    model_bytes: float           # weight bytes (decode is weight-bound)

    # per-forward fixed overhead (framework/launch, ~1 ms per layer on the
    # paper's vLLM testbed) — this is what bounds the paper's cached-prefix
    # speedup at 11.5x rather than the raw FLOP ratio
    fixed_overhead_s: float = 30e-3

    # disk tier (expansion storage below host DRAM): sequential-read
    # bandwidth of the local NVMe the mmap'd KV segments live on
    disk_bytes_per_s: float = 6e9

    # per-forward collective time (tensor-parallel all-reduce of the
    # activations after attention + MLP); 0 on single-device profiles,
    # set by with_tp() — this term does NOT shrink with tp, which is why
    # TP speedup saturates below linear
    collective_s: float = 0.0

    def with_tp(self, tp: int, ici_allreduce_s: float = 1.5e-3
                ) -> "HardwareProfile":
        """Derived profile for a tp-way tensor-parallel replica.

        Compute, HBM bandwidth, and the host link all scale by ``tp``
        (params, pool KV-head planes, and decode kernels are sharded over
        the mesh's model axis; promote/demote copies move per-shard slices
        in parallel), while every forward gains a ring all-reduce term
        ``2 (tp-1)/tp * ici_allreduce_s`` that grows with tp.  The
        simulator applies this via ``SimConfig.tp``.
        """
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if tp == 1:
            return self
        return dataclasses.replace(
            self, name=f"{self.name}-tp{tp}",
            flops_per_s=self.flops_per_s * tp,
            hbm_bytes_per_s=self.hbm_bytes_per_s * tp,
            pcie_bytes_per_s=self.pcie_bytes_per_s * tp,
            collective_s=self.collective_s
            + 2.0 * (tp - 1) / tp * ici_allreduce_s)

    def prefill_time(self, alpha: int, beta: int) -> float:
        """Time to prefill beta new tokens on top of alpha cached tokens."""
        if beta <= 0:
            return 0.0
        # dense FLOPs for the new tokens + attention against cached prefix
        flops = 2.0 * self.model_params * beta
        flops += 2.0 * 2.0 * beta * (alpha + beta / 2.0) * _attn_dim(self)
        # weights stream through SRAM at least once regardless of beta
        weight_floor = self.model_bytes / self.hbm_bytes_per_s
        return (flops / self.flops_per_s + weight_floor
                + self.fixed_overhead_s + self.collective_s)

    def transfer_time(self, n_bytes: float) -> float:
        return n_bytes / self.pcie_bytes_per_s + 1e-4

    def disk_transfer_time(self, n_bytes: float) -> float:
        """One host<->disk hop (mmap read or write of a KV segment)."""
        return n_bytes / self.disk_bytes_per_s + 1e-4

    def decode_time(self, batch: int, context: int) -> float:
        """One decode iteration for a batch (weight + KV reads, mem-bound)."""
        weight = self.model_bytes
        kv = batch * context * self.kv_bytes_per_token
        return (weight + kv) / self.hbm_bytes_per_s + 1e-3 + self.collective_s


def _attn_dim(p: HardwareProfile) -> float:
    # effective attention width: kv_bytes/token = 2 (k,v) * 2 bytes * L * d_kv
    return p.kv_bytes_per_token / 4.0


# Paper testbed: AWS g5.16xlarge, one A10G (24 GiB), PCIe 4.0x16.
# flops calibrated to paper Fig.2 (~1 s prefill at 4k tokens for a 7B model).
A10G_MISTRAL_7B = HardwareProfile(
    name="a10g-mistral-7b",
    flops_per_s=5.6e13,
    hbm_bytes_per_s=600e9,
    pcie_bytes_per_s=16e9,
    model_params=7.2e9,
    kv_bytes_per_token=0.125 * 2**20,
    model_bytes=14 * 2**30,
)
A10G_LLAMA2_7B = dataclasses.replace(
    A10G_MISTRAL_7B, name="a10g-llama2-7b", kv_bytes_per_token=0.5 * 2**20
)
H800_MIXTRAL = HardwareProfile(
    name="h800x2-mixtral-8x7b",
    flops_per_s=8e14,
    hbm_bytes_per_s=2 * 3.35e12,
    pcie_bytes_per_s=64e9,
    model_params=12.9e9,          # active (top-2 of 8 experts)
    kv_bytes_per_token=0.125 * 2**20,
    model_bytes=96.8 * 2**30,
)
H800_LLAMA2_70B = HardwareProfile(
    name="h800x2-llama2-70b",
    flops_per_s=8e14,
    hbm_bytes_per_s=2 * 3.35e12,
    pcie_bytes_per_s=64e9,
    model_params=70e9,
    kv_bytes_per_token=0.3125 * 2**20,
    model_bytes=140 * 2**30,
)
# TPU v5e target (per chip): the deployment profile for the TPU-native port.
TPU_V5E = HardwareProfile(
    name="tpu-v5e-chip",
    flops_per_s=0.5 * 197e12,     # ~50% MFU prefill
    hbm_bytes_per_s=819e9,
    pcie_bytes_per_s=16e9,        # host DRAM tier link
    model_params=7.2e9,
    kv_bytes_per_token=0.125 * 2**20,
    model_bytes=14 * 2**30,
)


class CostProfiler:
    """The T(alpha, beta) grid + bilinear interpolation of Algorithm 1."""

    def __init__(self, alphas: Sequence[int], betas: Sequence[int],
                 table: Dict[Tuple[int, int], float]):
        self.alphas = sorted(set(alphas))
        self.betas = sorted(set(betas))
        self.table = dict(table)

    @classmethod
    def from_fn(cls, fn: Callable[[int, int], float],
                alphas: Sequence[int], betas: Sequence[int]) -> "CostProfiler":
        tbl = {(a, b): fn(a, b) for a in alphas for b in betas}
        return cls(alphas, betas, tbl)

    @classmethod
    def from_profile(cls, prof: HardwareProfile,
                     alphas: Sequence[int] = (0, 128, 512, 1024, 2048, 4096, 8192),
                     betas: Sequence[int] = (1, 32, 128, 512, 1024, 2048, 4096),
                     ) -> "CostProfiler":
        return cls.from_fn(prof.prefill_time, alphas, betas)

    def _bracket(self, grid: List[int], x: int) -> Tuple[int, int, float]:
        if x <= grid[0]:
            return grid[0], grid[0], 0.0
        if x >= grid[-1]:
            # extrapolate linearly from the last interval
            lo, hi = grid[-2], grid[-1]
            return lo, hi, (x - lo) / (hi - lo)
        i = bisect.bisect_right(grid, x)
        lo, hi = grid[i - 1], grid[i]
        t = 0.0 if hi == lo else (x - lo) / (hi - lo)
        return lo, hi, t

    def estimate(self, alpha: int, beta: int) -> float:
        """Bilinear interpolation T(alpha, beta) — Alg. 1 lines 6–9."""
        al, ah, ta = self._bracket(self.alphas, int(alpha))
        bl, bh, tb = self._bracket(self.betas, int(beta))
        T = self.table
        t_l = T[(al, bl)] + ta * (T[(ah, bl)] - T[(al, bl)])
        t_h = T[(al, bh)] + ta * (T[(ah, bh)] - T[(al, bh)])
        return max(t_l + tb * (t_h - t_l), 0.0)


def measure_profiler(prefill_fn: Callable[[int, int], float],
                     alphas: Sequence[int], betas: Sequence[int],
                     repeats: int = 2) -> CostProfiler:
    """Build a profiler by timing a real prefill function (wall clock)."""
    import time
    tbl = {}
    for a in alphas:
        for b in betas:
            prefill_fn(a, b)  # warm-up / compile
            t0 = time.perf_counter()
            for _ in range(repeats):
                prefill_fn(a, b)
            tbl[(a, b)] = (time.perf_counter() - t0) / repeats
    return CostProfiler(alphas, betas, tbl)
