"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

The reference's tensor parallelism is single-controller: one process, a
``(data=1, model=tp)`` mesh of devices.  The port keeps that model with an
explicit, ordered list of ``torch.device``s: shard ``i`` of every sharded
param and of the paged pool lives on ``devices[i]``, and one process
launches every shard's work.  No process group, no ranks.

``slabs`` is the mesh's column-slab group G: every column product (wq, wk,
wv, wg, wu, the logits) is computed in G column slabs, a shard computing
its G / tp of them one call each.  A product's column does not keep its
bits when the call's width changes (cuBLAS, and the CPU's GEMMs, pick
their kernel and split of the contraction by (M, N, K);
``scripts/probe_column_slices.py``), so the bits of a serve are fixed by G
and not by tp: every mesh of one G gives the same tokens and logits, tp 1
included.  G defaults to tp, so a shard runs each column product as one
call and tp 1 runs the unslabbed products (no slab costs a one-card serve
anything); ``make_serving_mesh(1, slabs=N)`` is the one-device mesh whose
bits a tp-N serve reproduces.

``device="cpu"`` gives ``tp`` CPU shards, the counterpart of
``--xla_force_host_platform_device_count``.  An explicit ``devices`` list
may name one card more than once (``["cuda:0"] * tp``): every shard then
runs on that card, which is how one card shows the per-shard path.

Training runs on the reference's ``(data, model)`` shape: a ``DeviceMesh``
is an ordered grid of devices, ``grid[d][m]`` the device of data replica
``d``'s model shard ``m``; each row is one replica's ``ServingMesh`` (the
``(1, tp)`` case, ``replica(d)``), whose first device is that replica's
controller.  ``make_debug_mesh`` builds one (the reference's CI mesh,
(2, 4) by default), ``data_axes`` names its batch axes.
``make_production_mesh`` builds the reference's production shapes,
``(data 16, model 16)`` or ``(pod 2, data 16, model 16)``, over devices
the caller names: the compile analysis (``launch/dryrun.py``) gives it
fake cards.  A mesh with a ``pod`` axis keeps its replicas as rows in
(pod, data) order: ``pods`` splits them, and ``n_replicas`` counts them
whatever the axes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """One serving replica's mesh: ``shape == {"data": 1, "model": tp}``
    over ``devices``, shard ``i`` on ``devices[i]``, and its column-slab
    group ``slabs`` (0: tp)."""

    devices: Tuple[torch.device, ...]
    slabs: int = 0
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        tp = len(self.devices)
        if self.slabs == 0:
            object.__setattr__(self, "slabs", tp)
        if self.slabs % tp:
            raise ValueError(f"a column-slab group of {self.slabs} does not "
                             f"split over tp {tp}")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": 1, "model": len(self.devices)}

    @property
    def n_replicas(self) -> int:
        return 1

    @property
    def controller(self) -> torch.device:
        """The device that holds the replicated residual stream and runs
        the replicated products (shard 0's)."""
        return self.devices[0]

    def replica(self, d: int) -> "ServingMesh":
        if d != 0:
            raise IndexError(f"a serving mesh has one data replica, not {d}")
        return self


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A ``(data, model)`` grid of devices: ``grid[d][m]`` holds model
    shard ``m`` of data replica ``d``."""

    grid: Tuple[Tuple[torch.device, ...], ...]
    pods: int = 1

    def __post_init__(self):
        if not self.grid or len({len(row) for row in self.grid}) != 1:
            raise ValueError("a mesh's rows must be non-empty and of one "
                             "length")
        if self.pods < 1 or len(self.grid) % self.pods:
            raise ValueError(f"{len(self.grid)} replicas do not split into "
                             f"{self.pods} pods")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("pod",) if self.pods > 1 else ()) + ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        out = {"pod": self.pods} if self.pods > 1 else {}
        out.update(data=len(self.grid) // self.pods, model=len(self.grid[0]))
        return out

    @property
    def n_replicas(self) -> int:
        """The data replicas over every data axis (pod included)."""
        return len(self.grid)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Every device, row by row."""
        return tuple(dev for row in self.grid for dev in row)

    def replica(self, d: int) -> ServingMesh:
        """Data replica ``d``'s ``(1, model)`` mesh."""
        return ServingMesh(self.grid[d])


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of a mesh (pod included when present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _devices(n: int, device, devices, what: str) -> Tuple[torch.device, ...]:
    """``n`` devices: ``devices`` as given (a card may repeat), else ``n``
    CPU shards for ``device="cpu"``, else the cards ``cuda:0 .. n-1``."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if len(devs) != n:
            raise ValueError(f"{what} needs {n} devices, got {len(devs)}")
        return devs
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return (dev,) * n
    if n == 1 and dev.index is not None:
        return (dev,)
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if avail < n:
        raise ValueError(
            f"{what} needs {n} devices but only {avail} are visible; "
            f"on the CPU pass --device cpu"
        )
    return tuple(torch.device("cuda", i) for i in range(n))


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device=None,
                    devices: Sequence = None) -> DeviceMesh:
    """A ``(n_data, n_model)`` mesh (the reference's CI mesh, (2, 4) by
    default): ``devices`` lists its ``n_data * n_model`` devices row by row
    (a card may repeat); else ``device="cpu"`` gives CPU shards and
    ``None``/``"cuda"`` the first cards."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh ({n_data}, {n_model}) needs both sizes >= 1")
    devs = _devices(n_data * n_model, device, devices,
                    f"a ({n_data}, {n_model}) mesh")
    return DeviceMesh(tuple(devs[d * n_model:(d + 1) * n_model]
                            for d in range(n_data)))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Callable = None) -> DeviceMesh:
    """The reference's production mesh: ``(data 16, model 16)``, or two
    pods, ``(pod 2, data 16, model 16)``.  ``device(d, m)`` gives the
    device of data replica ``d``'s model shard ``m``; by default the card
    ``cuda:(16 d + m)``.  torch keeps a device index in 8 bits, so a mesh
    whose indices pass 127 raises here rather than wrap: the compile
    analysis (``launch/dryrun.py``) maps the replicas onto fewer fake
    cards itself.  Nothing here touches a device."""
    pods = 2 if multi_pod else 1
    n_data, n_model = 16 * pods, 16
    if device is None:
        def device(d, m):
            return torch.device("cuda", n_model * d + m)
    grid = []
    for d in range(n_data):
        row = []
        for m in range(n_model):
            dev = torch.device(device(d, m))
            if dev.index is not None and dev.index < 0:
                raise ValueError(f"device index of replica {d} shard {m} "
                                 f"is past torch's 127")
            row.append(dev)
        grid.append(tuple(row))
    return DeviceMesh(tuple(grid), pods=pods)


def make_serving_mesh(tp: int, device=None, devices: Sequence = None,
                      slabs: int = 0) -> ServingMesh:
    """One serving replica's mesh: ``(data=1, model=tp)``.

    ``devices`` names the shards' devices explicitly (``tp`` of them; a
    card may repeat).  Else ``device="cpu"`` gives ``tp`` CPU shards, and
    ``None`` or ``"cuda"`` the cards ``cuda:0 .. cuda:tp-1``, raising when
    fewer are visible (``"cuda:i"`` at tp 1: that card).  ``slabs``: the
    column-slab group, a multiple of tp (0: tp)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return ServingMesh(_devices(tp, device, devices, f"--tp {tp}"), slabs)
