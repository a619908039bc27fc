"""Per-card cost of a step as it runs (the port's counterpart of
``repro.launch.hlo_analysis``).

The reference parses the XLA HLO of a compiled program; the port never
produces HLO.  So ``analyze(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` (``Tally``) and tallies, for each device, the
quantities the reference's ``Totals`` reports, under its names:

  flops       the products' FLOPs (``torch.utils.flop_counter``'s formulas
              for mm, addmm, bmm, baddbmm and the convolutions), plus each
              hand-written kernel's call at its own formula (``note``)
  dot_bytes   the operands and output of each product and kernel call
  coll        bytes copied INTO the device from another one, by the
              reference's collective kinds (``COLLECTIVES``), and
              ``coll_count`` such copies
  bytes_out   bytes copied out of it (the link carries both ways)
  peak_bytes  the most bytes of live storage the device held (storages,
              not views: keyed by ``untyped_storage()``, freed by
              ``weakref.finalize``), the arguments included
  kernels     calls of each hand-written kernel

Every op the step dispatches is counted as it runs, so a loop's iterations
count as the reference's trip counts do.  A step on fake tensors
(``FakeTensorMode``) allocates nothing and reads no value: the compile
analysis (``launch/dryrun.py``) runs production shapes that way on fake
cards.  On real tensors the same tally holds; a kernel's plain version
(the CPU's) is then run with the tally paused, and counted at the
kernel's formula.

The kind of a copy is the one its call site names (``to``):
``all-gather`` for the gathers onto a replica's controller and the
ZeRO-1 slices back, ``all-reduce`` for row products' partial sums,
``reduce-scatter`` for the ZeRO-1 gradient slices to their owners.  A
copy made elsewhere (the residual sent to the shards, and every copy
autograd makes in the backward) is ``collective-permute``: a
point-to-point send, which is what every copy of a single controller is.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_aten = torch.ops.aten
_PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
_COPIES = {_aten._to_copy.default, _aten.copy_.default}
_SHAPE_OPS = {_aten.size.default, _aten.sym_size.int, _aten.stride.default,
              _aten.dim.default, _aten.numel.default,
              _aten.is_contiguous.default,
              _aten.storage_offset.default, _aten.sym_numel.default,
              torch.ops.prim.device.default}


@dataclasses.dataclass
class Totals:
    """One device's tally (the reference's ``Totals`` plus memory)."""
    flops: float = 0.0
    dot_bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_count: float = 0.0
    bytes_out: float = 0.0
    live_bytes: int = 0
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def bytes_in(self) -> float:
        return sum(self.coll.values())

    def figures(self) -> dict:
        """The tally as plain numbers (kernel calls by name)."""
        return {"flops": self.flops, "dot_bytes": self.dot_bytes,
                "coll": dict(self.coll), "coll_count": self.coll_count,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "peak_bytes": self.peak_bytes,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "kernels": dict(self.kernels)}


def active() -> Optional["Tally"]:
    """The ``Tally`` the running step reports to, if one is on the
    dispatch-mode stack."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, Tally):
            return mode
    return None


def to(t: torch.Tensor, device, kind: str) -> torch.Tensor:
    """``t.to(device)``, tallied as a copy of collective ``kind`` when a
    ``Tally`` runs (else just the copy)."""
    tally = active()
    if tally is None:
        return t.to(device)
    prev, tally.kind = tally.kind, kind
    try:
        return t.to(device)
    finally:
        tally.kind = prev


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes only, no storage of values)."""
    return isinstance(t, FakeTensor)


def note(device, flops: float, nbytes: float, kernel: str = "") -> None:
    """Count work the step does not run under the tally: a hand-written
    kernel's call (``kernel``, its name) or products a fake-tensor
    shortcut stands in for; their FLOPs and the bytes they read and
    write, on ``device``."""
    tally = active()
    if tally is None:
        return
    tot = tally.card(device)
    tot.flops += flops
    tot.dot_bytes += nbytes
    if kernel:
        tot.kernels[kernel] = tot.kernels.get(kernel, 0) + 1


class paused:
    """Within: the running tally counts nothing (a kernel's plain version
    run in its place); ``keep(t)`` then books ``t``'s storage."""

    def __enter__(self):
        self.tally = active()
        if self.tally is not None:
            self.tally.quiet += 1
        return self

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        if self.tally is not None:
            self.tally.track(t)
        return t

    def __exit__(self, *exc):
        if self.tally is not None:
            self.tally.quiet -= 1


class Tally(TorchDispatchMode):
    """The dispatch mode that keeps a ``Totals`` per device (``cards``)
    and the copies' bytes by (kind, src, dst) (``copies``)."""

    def __init__(self):
        super().__init__()
        self.cards: Dict[torch.device, Totals] = {}
        self.copies: Dict[Tuple[str, torch.device, torch.device], list] = {}
        self.quiet = 0
        self.kind: Optional[str] = None      # the next copy's, set by ``to``
        self._live: Dict[int, Tuple[torch.device, int]] = {}

    def card(self, device) -> Totals:
        device = torch.device(device)
        if device not in self.cards:
            self.cards[device] = Totals()
        return self.cards[device]

    def track(self, t) -> int:
        """Book ``t``'s storage on its device if it is new; its bytes if
        it was."""
        if not isinstance(t, torch.Tensor) or (
                t.device.type == "meta" and not is_fake(t)):
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = (t.device, n)
        tot = self.card(t.device)
        tot.live_bytes += n
        tot.peak_bytes = max(tot.peak_bytes, tot.live_bytes)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        dev, n = self._live.pop(key, (None, 0))
        if dev is not None:
            self.cards[dev].live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.quiet or func in _SHAPE_OPS:
            return out
        pkt = func._overloadpacket
        if pkt in flop_registry:
            tot = self.card(out.device)
            tot.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
            if pkt in _PRODUCTS:
                mats = [a for a in args if isinstance(a, torch.Tensor)][-2:]
                tot.dot_bytes += sum(a.nbytes for a in mats) + out.nbytes
        if func in _COPIES:
            src = args[1] if func is _aten.copy_.default else args[0]
            if src.device != out.device:
                n = src.nbytes
                kind = self.kind or "collective-permute"
                into = self.card(out.device)
                into.coll[kind] += n
                into.coll_count += 1
                self.card(src.device).bytes_out += n
                self.copies.setdefault((kind, src.device, out.device),
                                       []).append(n)
        for t in tree_flatten(out)[0]:
            self.track(t)
        return out

    def __enter__(self):
        if active() is not None:
            raise RuntimeError("one Tally at a time")
        return super().__enter__()


def analyze(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a ``Tally``; returns (its output,
    the tally).  The tensors in ``args`` are booked first, as the
    arguments (``argument_bytes``), and the output's storages after
    (``output_bytes``)."""
    tally = Tally()
    for t in tree_flatten((args, kwargs))[0]:
        n = tally.track(t)
        if n:
            tally.card(t.device).argument_bytes += n
    with tally:
        out = fn(*args, **kwargs)
    seen = set()
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor) and id(t.untyped_storage()) not in seen:
            seen.add(id(t.untyped_storage()))
            tally.card(t.device).output_bytes += t.untyped_storage().nbytes()
    return out, tally


def top_collectives(tally: Tally, n: int = 20):
    """The largest copies: [(total bytes, kind, "src -> dst x count")],
    largest first (the reference's ``top_collectives``, by device pair
    where it goes by op)."""
    out = [(float(sum(v)), kind, f"{src} -> {dst} x{len(v)}")
           for (kind, src, dst), v in tally.copies.items()]
    out.sort(reverse=True, key=lambda r: r[0])
    return out[:n]
