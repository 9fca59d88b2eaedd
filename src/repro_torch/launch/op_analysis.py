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
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCosts", "OpCounter", "analyze_ops", "local_bytes", "tensor_bytes"]

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
         "_local_scalar_dense"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpCosts:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = field(default_factory=dict)
    ops: int = 0

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
                self.costs.coll[kind] = self.costs.coll.get(kind, 0) + nbytes * (
                    2 if kind == "all-reduce" else 1)
            return out
        if func.is_view or name in _FREE:
            return out
        outs = _plain_tensors(out)
        self.costs.ops += 1
        self.costs.bytes += sum(tensor_bytes(t) for t in _plain_tensors((args, kwargs)))
        self.costs.bytes += sum(tensor_bytes(t) for t in outs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.costs.flops += count(*args, **kwargs, out_val=out)
        self._track(outs)
        return out


def analyze_ops(fn, *args, base_bytes: int = 0, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter`.
    Returns (result, costs, peak bytes)."""
    counter = OpCounter(base_bytes)
    with counter:
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

