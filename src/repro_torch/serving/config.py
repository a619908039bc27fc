"""Typed serving configuration (the EngineConfig surface), copied from
``repro.serving.config``.

Four frozen dataclasses, built ONCE from the parsed args, threaded through
the runtime / engine / simulator constructors.

  * ``MeshConfig``      — tensor-parallel geometry of ONE replica (the
                          ``--tp N`` surface; axis names match
                          ``launch/sharding.py``'s partition rules)
  * ``EngineConfig``    — everything one engine (continuous runtime or
                          sequential RAGServer) needs: cache-tier budgets,
                          scheduler knobs, paged-pool shape, attention
                          engine, and the mesh
  * ``FleetConfig``     — replica count + routing policy (the router)
  * ``FrontDoorConfig`` — query cache / SLO admission / autoscaler knobs
                          (the front door)

``config=`` is the SOLE constructor API.  Passing a legacy loose kwarg
raises ``TypeError`` naming the config field that replaced it — see the
migration note in docs/ARCHITECTURE.md §10.

Every config round-trips through the CLI: ``from_args(parse(to_cli()))``
is the identity (property-tested for MeshConfig in
tests/test_engine_config.py), so a config can be logged, re-run, or
shipped to a remote launcher as plain flags.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def reject_legacy_kwargs(ctor: str, kwargs: dict, config_cls,
                         aliases: Optional[dict] = None) -> None:
    """Fail loudly on legacy loose constructor kwargs.

    ``config=`` is the sole constructor API now; every stray kwarg raises a
    TypeError that names the config field replacing it (``aliases`` maps
    renamed kwargs, e.g. ReplicaRouter's ``policy`` -> FleetConfig.routing).
    """
    if not kwargs:
        return
    aliases = aliases or {}
    fields = {f.name for f in dataclasses.fields(config_cls)}
    hints = []
    for k in sorted(kwargs):
        field = aliases.get(k, k)
        if field in fields:
            hints.append(f"{k!r} -> pass config="
                         f"{config_cls.__name__}(..., {field}=...)")
        else:
            hints.append(f"{k!r} (no {config_cls.__name__} equivalent)")
    raise TypeError(
        f"{ctor}() got unexpected keyword argument(s): the loose-kwargs "
        f"constructor path was removed — config={config_cls.__name__}(...) "
        f"is the sole API (docs/ARCHITECTURE.md §10).  "
        + "; ".join(hints))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Tensor-parallel geometry of one serving replica.

    ``tp`` devices form a ``(data=1, model=tp)`` mesh
    (``launch/mesh.py::make_serving_mesh``); params shard per
    ``launch/sharding.py::param_spec`` and the paged pool shards its KV-head
    dim over ``axis``.  ``tp=1`` is the single-device engine (no mesh is
    ever built).  Replicas never share a mesh — TP is *within* a replica,
    affinity routing is *across* replicas (a 2D fleet).
    """
    tp: int = 1
    axis: str = "model"

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError(f"MeshConfig.tp must be >= 1, got {self.tp}")
        if not self.axis:
            raise ValueError("MeshConfig.axis must be a non-empty axis name")

    @classmethod
    def from_args(cls, args) -> "MeshConfig":
        return cls(tp=getattr(args, "tp", 1))

    def to_cli(self) -> Tuple[str, ...]:
        return ("--tp", str(self.tp))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything ONE engine needs; mirrors the serve.py flag surface."""
    gpu_cache_bytes: int = 64 * 2**20
    host_cache_bytes: int = 512 * 2**20
    disk_cache_bytes: int = 0
    disk_cache_dir: Optional[str] = None
    policy: str = "pgdsf"
    top_k: int = 2
    reorder: bool = True
    speculative: bool = True
    max_batch: int = 4
    max_prefill_bs: int = 4
    prefill_chunk: int = 0
    max_prefill_tokens: int = 0
    block_size: int = 16
    attn: str = "auto"
    attn_impl: Optional[str] = None
    search_time_scale: float = 1.0
    # KV-reuse discipline (docs/ARCHITECTURE.md §11): "prefix" = the
    # classic knowledge-tree longest-cached-prefix reuse (bit-identical);
    # "chunk" = per-doc chunk cache reused at any position with
    # `recompute_tokens` boundary rows recomputed per relocated chunk
    # (approximate — verify with --check-tokens tol:<eps>).
    reuse: str = "prefix"
    recompute_tokens: int = 16
    # Workload mode (docs/ARCHITECTURE.md §12): "rag" = classic staged
    # retrieval per request; "cag" = cache-augmented generation — the FULL
    # corpus KV is preloaded into the knowledge tree at startup (disk-tier
    # resident, promoted on demand through the PGDSF cascade) and requests
    # serve with ZERO retrieval stages (doc resolution is one synchronous
    # deterministic index probe at arrival).  Requires a disk tier
    # (disk_cache_bytes > 0) big enough for the whole corpus.
    mode: str = "rag"
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def __post_init__(self):
        if self.reuse not in ("prefix", "chunk"):
            raise ValueError(
                f"EngineConfig.reuse must be 'prefix' or 'chunk', "
                f"got {self.reuse!r}")
        if self.recompute_tokens < 0:
            raise ValueError("EngineConfig.recompute_tokens must be >= 0")
        if self.mode not in ("rag", "cag"):
            raise ValueError(
                f"EngineConfig.mode must be 'rag' or 'cag', "
                f"got {self.mode!r}")

    @classmethod
    def from_args(cls, args) -> "EngineConfig":
        return cls(
            gpu_cache_bytes=args.gpu_cache_bytes,
            host_cache_bytes=args.host_cache_bytes,
            disk_cache_bytes=args.disk_cache_bytes,
            disk_cache_dir=args.disk_cache_dir,
            policy=args.policy,
            top_k=args.top_k,
            reorder=not args.no_reorder,
            speculative=not args.no_spec,
            max_batch=args.max_batch,
            max_prefill_bs=getattr(args, "max_prefill_bs", 4),
            prefill_chunk=args.prefill_chunk,
            max_prefill_tokens=args.max_prefill_tokens,
            block_size=args.block_size,
            attn=args.attn,
            search_time_scale=args.search_scale,
            reuse=getattr(args, "reuse", "prefix"),
            recompute_tokens=getattr(args, "recompute_tokens", 16),
            mode=getattr(args, "mode", "rag"),
            mesh=MeshConfig.from_args(args),
        )

    def to_cli(self) -> Tuple[str, ...]:
        out = ["--gpu-cache-bytes", str(self.gpu_cache_bytes),
               "--host-cache-bytes", str(self.host_cache_bytes),
               "--disk-cache-bytes", str(self.disk_cache_bytes),
               "--policy", self.policy, "--top-k", str(self.top_k),
               "--max-batch", str(self.max_batch),
               "--max-prefill-bs", str(self.max_prefill_bs),
               "--prefill-chunk", str(self.prefill_chunk),
               "--max-prefill-tokens", str(self.max_prefill_tokens),
               "--block-size", str(self.block_size), "--attn", self.attn,
               "--search-scale", str(self.search_time_scale),
               "--reuse", self.reuse,
               "--recompute-tokens", str(self.recompute_tokens),
               "--mode", self.mode]
        if self.disk_cache_dir is not None:
            out += ["--disk-cache-dir", self.disk_cache_dir]
        if not self.reorder:
            out.append("--no-reorder")
        if not self.speculative:
            out.append("--no-spec")
        return tuple(out) + self.mesh.to_cli()


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Cross-replica layer: N independent engines behind the router."""
    replicas: int = 1
    routing: str = "affinity"
    max_queue_skew: int = 4
    # shadow-ledger bound of the router's per-replica routed-docs sets
    # (serving/router.py); once a loose ReplicaRouter kwarg
    max_shadow_paths: int = 4096

    @classmethod
    def from_args(cls, args) -> "FleetConfig":
        return cls(replicas=max(1, args.replicas), routing=args.routing,
                   max_queue_skew=args.max_queue_skew,
                   max_shadow_paths=getattr(args, "max_shadow_paths", 4096))

    def to_cli(self) -> Tuple[str, ...]:
        return ("--replicas", str(self.replicas), "--routing", self.routing,
                "--max-queue-skew", str(self.max_queue_skew),
                "--max-shadow-paths", str(self.max_shadow_paths))


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Front-door request layer (query cache + SLO admission + autoscaler)."""
    enabled: bool = False
    ttl: float = 60.0
    sim_threshold: float = 0.98
    capacity: int = 512
    autoscale: bool = False
    autoscale_min: int = 1
    scale_up_backlog: float = 8.0
    scale_down_backlog: float = 2.0
    cooldown: float = 2.0
    slo_ttft_ms: float = 500.0

    @classmethod
    def from_args(cls, args) -> "FrontDoorConfig":
        return cls(
            enabled=args.frontdoor, ttl=args.frontdoor_ttl,
            sim_threshold=args.frontdoor_sim_threshold,
            capacity=args.frontdoor_capacity, autoscale=args.autoscale,
            autoscale_min=args.autoscale_min,
            scale_up_backlog=args.scale_up_backlog,
            scale_down_backlog=args.scale_down_backlog,
            cooldown=args.autoscale_cooldown, slo_ttft_ms=args.slo_ttft_ms)

    def to_cli(self) -> Tuple[str, ...]:
        out = ["--frontdoor-ttl", str(self.ttl),
               "--frontdoor-sim-threshold", str(self.sim_threshold),
               "--frontdoor-capacity", str(self.capacity),
               "--autoscale-min", str(self.autoscale_min),
               "--scale-up-backlog", str(self.scale_up_backlog),
               "--scale-down-backlog", str(self.scale_down_backlog),
               "--autoscale-cooldown", str(self.cooldown),
               "--slo-ttft-ms", str(self.slo_ttft_ms)]
        if self.enabled:
            out.append("--frontdoor")
        if self.autoscale:
            out.append("--autoscale")
        return tuple(out)
