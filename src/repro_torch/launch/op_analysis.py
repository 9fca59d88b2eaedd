"""Per-device cost analysis of one eager run, the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference walks the compiled, partitioned HLO of a cell.  Eager PyTorch
has no such program: it launches one kernel an op, as post-fusion HLO has
one kernel an instruction, so the same three roofline inputs are counted op
by op while the cell's step runs once (on fake tensors for the dry-run) under
:class:`OpCounter`, a ``TorchDispatchMode``:

  flops  -- 2 * M * N * K for every mm/bmm/addmm/baddbmm/convolution (and
            attention kernels), from ``torch.utils.flop_counter``'s formulas
  bytes  -- operand + result bytes of every op that reaches a kernel (views,
            metadata ops and waits move nothing)
  coll   -- payloads of the functional collectives by kind (result bytes;
            all-reduce counted 2x for its reduce-scatter + all-gather
            phases), as ``repro/launch/cells.py`` counts them; an
            all-to-all that sends to one rank of several is the
            collective-permute it implements (``parallel.collectives.ppermute``)

Only ops on plain (local) tensors count.  An op on DTensors reaches the
mode first at the DTensor level, with the global shapes; the mode hands it
back (``NotImplemented``) so that DTensor runs it, and counts the local ops
and collectives DTensor then runs.  Counting the DTensor-level op too would
add the global work to every device's (``FlopCounterMode`` does).  So
every number here is per device.

The mode also keeps the peak of the bytes held by the tensors the run made
(``peak_bytes``), on top of the bytes held before it started.
:class:`OpBreakdown` files each op's share by op and shapes, by source line
and by collective kind (``scripts/cell_breakdown_torch.py`` prints it).
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["OpBreakdown", "OpCosts", "OpCounter", "Share", "analyze_ops", "local_bytes",
           "tensor_bytes"]

# functional collectives (torch.distributed._functional_collectives and the
# autograd variants) -> the reference's HLO names
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# ops that launch no kernel (views are told apart by their schema)
_FREE = {"detach", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_local_scalar_dense", "device"}  # prim.device: a tensor's device


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpCosts:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = field(default_factory=dict)
    ops: int = 0
    # {"op": {(op, argument shapes): Share}, "site": {line: Share},
    #  "coll": {kind: Share}}, kept by OpBreakdown
    breakdown: dict | None = None

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))


def _one_peer(splits) -> bool:
    """An all-to-all whose input goes to one rank of several: a permute."""
    return len(splits) > 1 and sum(1 for k in splits if k) == 1


def _plain_tensors(xs) -> list[torch.Tensor]:
    return [x for x in tree_flatten(xs)[0] if isinstance(x, torch.Tensor)]


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class OpCounter(TorchDispatchMode):
    """Counts :class:`OpCosts` of the local ops run under it (see the module
    docstring), and the peak of the bytes their results hold."""

    def __init__(self, base_bytes: int = 0) -> None:
        super().__init__()
        self.costs = OpCosts()
        self._live: dict[int, tuple] = {}  # storage id -> (weak ref, bytes)
        self._base = base_bytes
        self._held = 0
        self.peak_bytes = base_bytes

    def _track(self, outs) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = (StorageWeakRef(st), st.nbytes())
            self._held += st.nbytes()
        if self._base + self._held > self.peak_bytes:
            # drop the storages that died since the last look before
            # taking a new peak
            for key, (ref, n) in list(self._live.items()):
                if ref.expired():
                    del self._live[key]
                    self._held -= n
            self.peak_bytes = max(self.peak_bytes, self._base + self._held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(_is_dtensor_type(t) for t in types):
            # the DTensor-level op: let DTensor run it, and count the local
            # ops it runs, which come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional"):
            kind = _COLLECTIVES.get(name)
            if kind == "all-to-all" and _one_peer(args[2]):
                kind = "collective-permute"  # collectives.ppermute
            if kind is not None:
                nbytes = sum(tensor_bytes(t) for t in _plain_tensors(out))
                nbytes *= 2 if kind == "all-reduce" else 1
                self.costs.coll[kind] = self.costs.coll.get(kind, 0) + nbytes
                self._file(func, args, 0, 0, kind, nbytes)
            return out
        if func.is_view or name in _FREE:
            return out
        outs = _plain_tensors(out)
        self.costs.ops += 1
        nbytes = sum(tensor_bytes(t) for t in _plain_tensors((args, kwargs)))
        nbytes += sum(tensor_bytes(t) for t in outs)
        self.costs.bytes += nbytes
        count = flop_registry.get(func._overloadpacket)
        flops = count(*args, **kwargs, out_val=out) if count is not None else 0
        self.costs.flops += flops
        self._file(func, args, flops, nbytes, None, 0)
        self._track(outs)
        return out

    def _file(self, func, args, flops, nbytes, kind, coll) -> None:
        """Hook for :class:`OpBreakdown`: one counted op's share."""


# Files whose frames are plumbing, not the model's own lines: a breakdown
# names the first frame outside them.
_PLUMBING = (os.path.join("parallel", "sharding.py"), os.path.join("parallel", "collectives.py"),
             os.path.join("launch", "op_analysis.py"))
_PKG = os.sep + "repro_torch" + os.sep
_FRAME_RE = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _site(frames) -> list[str]:
    """``["pkg/file.py:line (function)", ...]`` for the ``repro_torch``
    frames of ``frames`` ((file, line, function), innermost first) that are
    not plumbing."""
    out = []
    for path, line, fn in frames:
        if _PKG in path and not path.endswith(_PLUMBING):
            out.append(f"{path.rsplit(_PKG, 1)[1]}:{line} ({fn})")
    return out


def _python_frames():
    f = sys._getframe()
    while f is not None:
        yield f.f_code.co_filename, f.f_lineno, f.f_code.co_name
        f = f.f_back


def _forward_frames(node):
    """The frames that made autograd ``node`` (recorded by anomaly mode),
    innermost first."""
    tb = node.metadata.get("traceback_") or ()
    return [m.groups() for m in reversed([_FRAME_RE.search(e) for e in tb]) if m]


@dataclass
class Share:
    """One breakdown entry: what the ops filed under a key cost."""

    flops: float = 0.0
    bytes: float = 0.0
    coll: float = 0.0
    calls: int = 0  # ops and collectives


class OpBreakdown(OpCounter):
    """:class:`OpCounter` that also files each counted op's FLOPs, bytes and
    collective bytes under three keys, in ``costs.breakdown`` (the
    counterpart of the reference's ``scripts/cell_breakdown.py``):

      "op"    -- ``(op, argument shapes)``
      "site"  -- the innermost ``repro_torch`` line outside the sharding
                  plumbing, with its caller; a backward op is filed under
                  the forward line that made its autograd node, tagged
                  ``[bwd]`` (``[recompute]`` for a checkpointed forward
                  run again in backward)
      "coll"  -- the collective kind (``"-"`` for local ops)

    Each key's FLOPs, bytes and collective bytes sum to ``costs``' exactly
    (every figure is an integer).  Run it under anomaly mode
    (``analyze_ops(..., breakdown=True)`` does) so that backward ops find
    their forward lines."""

    def __init__(self, base_bytes: int = 0) -> None:
        super().__init__(base_bytes)
        self.costs.breakdown = {k: defaultdict(Share) for k in ("op", "site", "coll")}

    def _file(self, func, args, flops, nbytes, kind, coll) -> None:
        shapes = tuple(tuple(t.shape) for t in _plain_tensors(args))
        node = torch._C._current_autograd_node()
        sites = _site(_python_frames())
        tag = ""
        if node is not None:
            fwd = _site(_forward_frames(node))
            if not sites or sites[0].startswith("autodiff.py"):  # autograd's own op
                sites, tag = fwd, " [bwd]"
            else:
                tag = " [recompute]"
        site = " < ".join(sites[:2]) + tag if sites else "(outside repro_torch)"
        tables = self.costs.breakdown
        for table, key in (("op", (str(func._overloadpacket), shapes)), ("site", site),
                           ("coll", kind or "-")):
            sh = tables[table][key]
            sh.flops += flops
            sh.bytes += nbytes
            sh.coll += coll
            sh.calls += 1


def analyze_ops(fn, *args, base_bytes: int = 0, breakdown: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` (an
    :class:`OpBreakdown`, under anomaly mode, with ``breakdown``).  Returns
    (result, costs, peak bytes)."""
    counter = (OpBreakdown if breakdown else OpCounter)(base_bytes)
    anomaly = torch.autograd.set_detect_anomaly(True, check_nan=False) if breakdown \
        else contextlib.nullcontext()
    with anomaly, counter:
        result = fn(*args, **kwargs)
    return result, counter.costs, counter.peak_bytes


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local piece)."""
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if _is_dtensor(t) else t
            total += tensor_bytes(t)
    return total

