"""Logical-axis -> mesh-axis sharding rules, as in ``repro/parallel/sharding.py``.

Weights carry *logical* axis names (``repro_torch.models.lm.logical_axes``);
this module maps them onto a ``torch.distributed`` ``DeviceMesh`` whose
dimensions are named like the reference's mesh axes:

  'model' axis : tensor parallelism (attention heads, ffn, experts, vocab)
  'data'  axis : FSDP -- the non-TP weight dim is sharded over 'data'
  'pod'   axis : pure data parallelism across pods (weights replicated)

Batch/activations: batch dim over ('pod', 'data').

The reference's GSPMD becomes DTensor: a spec (one entry per tensor dim: a
mesh-axis name, a tuple of names, or ``None``) turns into ``Shard`` /
``Replicate`` placements (:func:`placements_for`), a parameter tree into a
DTensor tree (:func:`distribute_tree`), a sharding constraint into a
``redistribute`` (:func:`constrain`) and ``shard_map`` into ``local_map``
(:func:`shard_map_compat`).  Without a mesh every function here leaves its
tensors as they are; with one, a missing DTensor API raises: nothing runs
unsharded in its place.
"""

from __future__ import annotations

import functools
import inspect
from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = [
    "DEFAULT_RULES",
    "NamedSharding",
    "ParallelContext",
    "axis_names",
    "axis_sizes",
    "compute_layout",
    "constrain",
    "distribute",
    "distribute_tree",
    "gather_last",
    "make_context",
    "map_specs",
    "merge_heads",
    "mesh_region",
    "over_batch",
    "over_batch_and_heads",
    "partial_sums",
    "place",
    "placements_for",
    "serve_context",
    "set_index",
    "shard_map_compat",
    "shardings_for",
    "spec_of",
    "spec_for",
    "split_heads",
    "split_over_sequence",
    "vocab_log_prob",
    "vocab_lookup",
]

# logical axis -> mesh axis (None = replicate)
DEFAULT_RULES: dict[str | None, str | tuple[str, ...] | None] = {
    "vocab": "model",
    "embed": "data",      # FSDP dim
    "ffn": "model",
    "heads": "model",
    "kv": "model",
    "experts": "model",
    "lora": None,
    "layers": None,
    "state": None,
    None: None,
}


def axis_names(mesh) -> tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    keys of a ``.shape`` mapping (a stand-in that carries sizes only)."""
    if isinstance(getattr(mesh, "shape", None), Mapping):
        return tuple(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a sharding mesh needs named dimensions")
    return tuple(names)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a stand-in whose
    ``.shape`` is that mapping already)."""
    if isinstance(getattr(mesh, "shape", None), Mapping):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


@dataclass(frozen=True)
class ParallelContext:
    mesh: object | None  # a named DeviceMesh, or None (mesh-free)
    dp_axes: tuple[str, ...] = ("data",)  # batch axes (('pod','data') multi-pod)
    tp_axis: str = "model"
    # mesh axes the EXPERT dim is sharded over.  Training: ("model",) -- EP
    # folded into TP, weights additionally FSDP'd over 'data'.  Serving
    # (serve_context): ("data", "model") -- full EP across the mesh, token
    # replication + global all-reduce instead of per-layer weight gathers.
    ep_axes: tuple[str, ...] = ("model",)
    rules: tuple = tuple(DEFAULT_RULES.items())

    def rule(self, logical):
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def dp_spec(self, batch: int):
        """The spec entry of a batch dim of size ``batch``: the DP axes when
        they divide it, else ``None`` (replicated, and always without a
        mesh)."""
        if self.mesh is None or batch % self.size(self.dp_axes):
            return None
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def size(self, axes) -> int:
        """Product of the mesh sizes of ``axes`` (a name or names)."""
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= sizes[a]
        return n


def make_context(mesh, rules: dict | None = None) -> ParallelContext:
    if mesh is None:
        return ParallelContext(mesh=None)
    dp = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    return ParallelContext(mesh=mesh, dp_axes=dp, rules=tuple(merged.items()))


def serve_context(mesh, num_experts: int = 0) -> ParallelContext:
    """Inference parameter layout, as the reference's: dense weights TP over
    'model' and replicated over 'data' (no FSDP gathers per decode step);
    expert weights full EP over ('data' x 'model') when the expert count
    divides it, the token batch gathered instead of the weights."""
    if mesh is None:
        return ParallelContext(mesh=None)
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    dp = ("pod", "data") if "pod" in names else ("data",)
    # Widest EP grid the expert count divides (experts may stay replicated
    # across 'pod').
    ep_axes: tuple[str, ...] = ("model",)
    for cand in ((*dp, "model"), ("data", "model")):
        size = 1
        for a in cand:
            if a not in names:
                size = 0
                break
            size *= sizes[a]
        if size and num_experts > 0 and num_experts % size == 0:
            ep_axes = cand
            break
    rules = dict(DEFAULT_RULES)
    rules["embed"] = None  # no FSDP dim at serving time
    if len(ep_axes) > 1:
        rules["experts"] = ep_axes
    return ParallelContext(mesh=mesh, dp_axes=dp, ep_axes=ep_axes, rules=tuple(rules.items()))


def spec_for(axes: tuple, ctx: ParallelContext, shape: tuple[int, ...] | None = None) -> tuple:
    """Spec for one param from its logical axes: one entry per dim, a mesh
    axis, a tuple of them, or ``None``.

    Guards against (a) using the same mesh axis twice (e.g. a [ffn, ffn]
    square weight -- the second occurrence is replicated) and (b) dims not
    divisible by the mesh-axis size when ``shape`` is given (replicated).
    """
    used: set[str] = set()
    out = []
    sizes = axis_sizes(ctx.mesh) if ctx.mesh is not None else {}
    for i, a in enumerate(axes):
        m = ctx.rule(a)
        parts = (m,) if isinstance(m, str) else tuple(m or ())
        if parts and shape is not None and ctx.mesh is not None:
            size = 1
            for ax in parts:
                size *= sizes[ax]
            if shape[i] % size != 0:
                parts = ()
        if not parts or any(ax in used for ax in parts):
            out.append(None)
        else:
            out.append(parts if len(parts) > 1 else parts[0])
            used.update(parts)
    return tuple(out)


def placements_for(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every mesh
    dim of more than one rank that tensor dim ``d`` names, ``Replicate()``
    elsewhere.  A dim over
    several axes (``("pod", "data")``) is split major axis first, as JAX
    splits it, so its axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        parts = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in parts]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            # a split over one rank is the whole tensor: DTensor refuses to
            # view a size-1 dim that is sharded, even over one rank
            out[i] = Shard(d) if sizes[names[i]] > 1 else Replicate()
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``placements`` (a
    view where it can be: on a one-rank mesh it is ``t`` itself)."""
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(mdim)
            step = t.shape[p.dim] // n
            t = t.narrow(p.dim, coord[mdim] * step, step)
    return t


def distribute(t: torch.Tensor, mesh, spec, placements=None):
    """``t`` (the full tensor, the same on every rank) as a DTensor with
    ``spec``'s placements (or ``placements`` given as they are): each rank
    keeps its own piece, no collective.  Dims must divide evenly
    (``spec_for`` with a shape guarantees it)."""
    from torch.distributed.tensor import DTensor

    placements = placements_for(spec, mesh) if placements is None else list(placements)
    local = _local_chunk(t, mesh, placements)
    if local is not t:
        local = local.contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each piece of a tensor lives (JAX's
    ``NamedSharding``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements_for(self.spec, self.mesh)


def place(x, sharding: NamedSharding | None):
    """``x`` laid out by ``sharding``: a plain tensor (the full value, the
    same on every rank) is cut to this rank's piece, a DTensor is
    redistributed; ``None`` (no sharding, or no tensor) leaves ``x``."""
    if sharding is None or x is None:
        return x
    if _is_dtensor(x):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute(x, sharding.mesh, sharding.spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_axes(tree):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def map_specs(fn, spec_tree):
    """``fn`` over every spec (a tuple of axis entries) of ``spec_tree``."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list) or (isinstance(spec_tree, tuple) and not _is_spec(spec_tree)):
        return type(spec_tree)(map_specs(fn, v) for v in spec_tree)
    return fn(spec_tree)


def shardings_for(axes_tree, ctx: ParallelContext, shapes=None):
    """Tree of logical-axes tuples -> tree of :class:`NamedSharding` (or
    ``None`` leaves without a mesh).  ``shapes``: optional matching tree of
    shape-carrying leaves, enabling the divisibility guard."""
    if ctx.mesh is None:
        return _map2(lambda a, _: None, axes_tree, axes_tree)
    if shapes is None:
        return _map2(lambda a, _: NamedSharding(ctx.mesh, spec_for(a, ctx)), axes_tree, axes_tree)
    return _map2(lambda a, s: NamedSharding(ctx.mesh, spec_for(a, ctx, tuple(s.shape))),
                 axes_tree, shapes)


def distribute_tree(tree, shardings):
    """A tensor tree laid out by a matching tree of :class:`NamedSharding`
    (:func:`place` on every leaf); ``None`` shardings and leaves pass."""
    if shardings is None:
        return tree
    return _map2(place, tree, shardings)


def constrain(x, ctx: ParallelContext | None, dims: tuple):
    """Activation sharding constraint.  ``dims``: per-dim 'dp' | 'tp' | None.

    Pins the canonical activation layout -- batch over the DP axes,
    feature/vocab over 'model', replicated elsewhere -- as a
    ``redistribute``; dims that don't divide evenly are left replicated.
    The gradient is pinned to the same layout, as JAX transposes a
    constraint into one on the cotangent: partial sums are reduced here
    (Megatron's backward all-reduce), where left alone DTensor carries them
    to the next product and gathers its weight whole.
    A no-op without a mesh or on a plain tensor.
    """
    if ctx is None or ctx.mesh is None or not _is_dtensor(x):
        return x
    spec = []
    for i, d in enumerate(dims):
        if d == "dp":
            spec.append(ctx.dp_spec(x.shape[i]))
        elif d == "tp":
            spec.append(ctx.tp_axis if x.shape[i] % ctx.size(ctx.tp_axis) == 0 else None)
        else:
            spec.append(None)
    return _grad_in_layout(x.redistribute(ctx.mesh, placements_for(tuple(spec), ctx.mesh)))


def _grad_in_layout(y):
    """DTensor ``y`` as it is, with its gradient brought to ``y``'s own
    placements on the way back (``from_local``'s backward redistributes
    to them)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(y.to_local(), y.device_mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


def partial_sums(t, axis: str):
    """DTensor ``t``, whose pieces over ``axis`` are partial sums of the
    whole (a row-parallel product run in a region), read as ``Partial``
    there: DTensor reduces them where they are next used whole, as it
    reduces a product of DTensors split so, and the gradient comes back
    whole to each rank."""
    from torch.distributed.tensor import DTensor, Partial

    i = axis_names(t.device_mesh).index(axis)
    pl = [Partial() if j == i else p for j, p in enumerate(t.placements)]
    return DTensor.from_local(t.to_local(), t.device_mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_map_compat(f, *, mesh, in_specs, out_specs):
    """The reference's ``shard_map`` as ``local_map``: ``f`` runs on each
    rank's local pieces, laid out by ``in_specs`` (inputs are redistributed
    to them; ``None`` for an argument that is not a tensor), and its outputs
    are read as ``out_specs`` (a list for several).

    Gradients: a tensor input replicated over a mesh dim that splits the
    work -- one that some input or output is split over -- meets ranks that
    compute different things from it, so its gradient there is the sum of
    theirs (``Partial``).  Elsewhere it keeps its input layout."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    def pl(spec):
        return None if spec is None else placements_for(tuple(spec), mesh)

    ins = tuple(pl(s) for s in in_specs)
    outs = [pl(s) for s in out_specs] if isinstance(out_specs, list) else [pl(out_specs)]
    split = {i for p in (*ins, *outs) if p is not None for i, q in enumerate(p) if q.is_shard()}
    grads = tuple(None if p is None else
                  [Partial() if i in split and q.is_replicate() else q for i, q in enumerate(p)]
                  for p in ins)
    return local_map(f, out_placements=tuple(outs) if isinstance(out_specs, list) else outs[0],
                     in_placements=ins, in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def spec_of(t) -> tuple:
    """The spec of DTensor ``t``'s placements (the inverse of
    :func:`placements_for`; a ``Partial`` dim reads as replicated)."""
    names = axis_names(t.device_mesh)
    axes: list[list[str]] = [[] for _ in range(t.ndim)]
    for i, p in enumerate(t.placements):
        if p.is_shard():
            axes[p.dim].append(names[i])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes)


def mesh_region(fn):
    """Run ``fn(..., ctx=...)`` under DTensor's ``implicit_replication`` when
    ``ctx`` holds a mesh: tensors the model makes inside (positions, masks,
    running maxima) then join its DTensors as replicated ones.  Mesh-free
    calls run ``fn`` as it is."""
    params = inspect.signature(fn).parameters
    ctx_at = list(params).index("ctx")
    default = params["ctx"].default

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        ctx = kwargs.get("ctx", args[ctx_at] if len(args) > ctx_at else default)
        if ctx is None or getattr(ctx, "mesh", None) is None:
            return fn(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        # the context is not reentrant: its exit switches it off, so an
        # inner region (loss_fn in a train step) must not enter it again
        if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
            return fn(*args, **kwargs)
        with implicit_replication():
            return fn(*args, **kwargs)

    return wrapped


def set_index(buf: torch.Tensor, dim: int, index: int, value: torch.Tensor) -> None:
    """``buf.select(dim, index).copy_(value)``, in place, also on a DTensor
    whose ``dim`` is sharded: DTensor's ``select`` of a sharded dim returns
    a gathered copy, and a write into it would be lost.  There only the
    rank that holds ``index`` writes, into its local piece."""
    if not _is_dtensor(buf):
        buf.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, coord = buf.device_mesh, buf.device_mesh.get_coordinate()
    row_pl = []
    mine, length, local_index = True, buf.shape[dim], index
    for mdim, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == dim:
            length //= mesh.size(mdim)
            owner, local_index = divmod(local_index, length)
            mine = mine and coord[mdim] == owner
            row_pl.append(Replicate())
        elif isinstance(p, Shard):
            row_pl.append(Shard(p.dim - (p.dim > dim)))
        else:
            row_pl.append(p)
    if _is_dtensor(value):  # every rank joins the redistribute
        value = value.redistribute(mesh, row_pl).to_local()
    else:  # a plain tensor is the full row: cut this rank's piece of it
        value = _local_chunk(value, mesh, row_pl)
    if mine:
        buf.to_local().select(dim, local_index).copy_(value)


def compute_layout(tree, ctx: ParallelContext | None):
    """Parameters as one layer computes with them: their FSDP shards (the
    'embed' dim over 'data' in the training layout) gathered, the TP shards
    kept -- the all-gather XLA inserts per scan step.  Gathering them before
    use pins DTensor to plain tensor-parallel products, where left alone it
    picks layouts that split the sequence and cost minutes of planning on a
    three-axis mesh.  A gathered weight's gradient comes back
    reduce-scattered to its shards.  A no-op without a mesh or without an
    FSDP rule (the serving layout)."""
    fsdp = ctx.rule("embed") if ctx is not None and ctx.mesh is not None else None
    if fsdp is None:
        return tree
    from torch.distributed.tensor import Replicate

    dim = axis_names(ctx.mesh).index(fsdp)

    def one(t):
        if not _is_dtensor(t) or not t.placements[dim].is_shard():
            return t
        pl = list(t.placements)
        pl[dim] = Replicate()
        return t.redistribute(t.device_mesh, pl)

    if isinstance(tree, dict):
        return {k: compute_layout(v, ctx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(compute_layout(v, ctx) for v in tree)
    return one(tree)


def split_over_sequence(t) -> bool:
    """Whether ``t`` [B, S, ...] is a DTensor whose dim 1 is split."""
    return _is_dtensor(t) and any(p.is_shard(1) for p in t.placements)


def gather_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim whole on every rank (a DTensor's shards of it
    gathered): for a packed projection whose pieces are sliced out next,
    which a contiguous split over 'model' cuts across -- Mamba-2's [z, x,
    B, C, dt] at decode (``ssm.ssm_decode``), and in training or prefill
    only where its heads do not split over 'model' whole (``ssm_apply``
    otherwise projects each rank's own columns)."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    last = t.ndim - 1
    pl = [Replicate() if p.is_shard(last) else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``t`` [..., heads * head_dim] as [..., heads, head_dim].  On a
    DTensor whose last dim is split into pieces that are not whole heads,
    the pieces are gathered first: DTensor cannot view a head that
    straddles ranks (GSPMD reshuffles it)."""
    if _is_dtensor(t):
        from torch.distributed.tensor import Replicate

        last = t.ndim - 1
        pl = list(t.placements)
        for i, p in enumerate(pl):
            if p.is_shard(last) and heads % t.device_mesh.size(i):
                pl[i] = Replicate()
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], heads, head_dim)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, ..., heads, head_dim] as [B, ..., heads * head_dim], the
    inverse of :func:`split_heads`, for the row-parallel output product.
    On a DTensor the result is pinned (:func:`constrain`) to batch over the
    DP axes and the merged dim over 'model', as GSPMD lays it out: where
    the heads were padded to divide 'model' and gathered back, the product
    and its weight gradient then run on each rank's slice of the merged
    dim, not on the whole.  Its gradient comes back in that layout too,
    which a view back into heads that do not divide the split cannot
    take."""
    y = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if not _is_dtensor(y):
        return y
    return constrain(y, make_context(y.device_mesh), ("dp",) + (None,) * (y.ndim - 2) + ("tp",))


def over_batch_and_heads(fn, q: torch.Tensor, *kvs: torch.Tensor, **kwargs):
    """``fn(q, *kvs, **kwargs)`` for attention's core -- tensors ``[B, S, H,
    ...]`` whose rows and query heads are independent; ``kvs`` hold the
    key/value heads, of which query head ``i`` reads head ``i // (H /
    Hkv)`` -- run per rank on its local pieces (:func:`shard_map_compat`):
    batch over the DP axes, query heads over 'model', and the key/value
    heads too when theirs divide it.  Query heads that do not divide
    'model' are padded with zero heads whose outputs are dropped, as GSPMD
    pads an uneven split: each rank does ceil(H / |model|) heads.  Where
    the key/value heads are not split, each rank keeps all of them and
    reads the ones its query heads need.  DTensor then never propagates
    the core's many small ops one by one (on a three-axis mesh that takes
    it minutes).  The result has ``q``'s layout.  Plain tensors go
    straight to ``fn``."""
    if not _is_dtensor(q):
        return fn(q, *kvs, **kwargs)
    mesh = q.device_mesh
    names = axis_names(mesh)
    tpn = axis_sizes(mesh).get("model", 1)
    bdim = make_context(mesh).dp_spec(q.shape[0])
    h = q.shape[2]
    pad = -h % tpn
    if pad:
        q = F.pad(q, (0, 0) * (q.ndim - 3) + (0, pad))
    heads = "model" if "model" in names else None
    kv_split = heads and not pad and all(t.shape[2] % tpn == 0 for t in kvs)
    q_spec = (bdim, None, heads)
    kv_spec = (bdim, None, heads if kv_split else None)
    core = functools.partial(fn, **kwargs)
    if heads and not kv_split:
        h_loc, group = q.shape[2] // tpn, h // kvs[0].shape[2]
        first = mesh.get_coordinate()[names.index("model")] * h_loc

        def core(q_loc, *kv_loc):
            idx = (first + torch.arange(h_loc, device=q_loc.device)).clamp(max=h - 1) // group
            return fn(q_loc, *(t.index_select(2, idx) for t in kv_loc), **kwargs)

    out = shard_map_compat(core, mesh=mesh, in_specs=(q_spec, *[kv_spec] * len(kvs)),
                           out_specs=q_spec)(q, *kvs)
    return out[:, :, :h] if pad else out


def over_batch(fn, xs: tuple, weights: tuple = (), n_out: int = 1):
    """``fn(*xs, *weights)`` per rank on its batch rows
    (:func:`shard_map_compat`): every ``xs`` tensor split over the DP axes
    on dim 0, every ``weights`` tensor whole on each rank, the ``n_out``
    results split like ``xs``.  Plain tensors go straight to ``fn``."""
    if not _is_dtensor(xs[0]):
        return fn(*xs, *weights)
    mesh = xs[0].device_mesh
    x_spec = (make_context(mesh).dp_spec(xs[0].shape[0]),)
    return shard_map_compat(fn, mesh=mesh, in_specs=(x_spec,) * len(xs) + ((),) * len(weights),
                            out_specs=x_spec if n_out == 1 else [x_spec] * n_out)(*xs, *weights)


def _vocab_split(t: torch.Tensor, dim: int):
    """(mesh, 'model' axes that split ``t``'s vocab dim ``dim`` in the
    region, or ``()`` on a mesh without a 'model' axis of more than one
    rank).  A vocab that 'model' does not divide raises: the op-by-op
    path would gather it whole."""
    mesh = t.device_mesh
    sizes = axis_sizes(mesh)
    if sizes.get("model", 1) == 1:
        return mesh, ()
    if t.shape[dim] % sizes["model"]:
        raise ValueError(f"a vocab of {t.shape[dim]} does not split over 'model' "
                         f"({sizes['model']} ranks)")
    return mesh, ("model",)


def _replicated(t: torch.Tensor, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor is the full value on
    every rank."""
    return t if _is_dtensor(t) else distribute(t, mesh, (None,) * t.ndim)


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` ([V, d] rows of ``tokens`` [B, ...]).  On a DTensor
    table, Megatron's vocab-parallel lookup under :func:`shard_map_compat`:
    each rank takes its rows of the table over 'model' and its batch rows
    of the tokens, looks up the tokens in its own vocab range, zeroes the
    others and sums the pieces over 'model'; no rank gathers the table.
    The table's gradient is a scatter-add into each rank's own rows (the
    tokens are split over the DP axes, so it is summed over those).  Plain
    tensors index directly."""
    if not _is_dtensor(table):
        return table[tokens]
    from . import collectives as coll

    mesh, tp = _vocab_split(table, 0)
    tokens = _replicated(tokens, mesh)
    t_spec = (make_context(mesh).dp_spec(tokens.shape[0]),) + (None,) * (tokens.ndim - 1)

    def local(tab, tok):
        v_loc = tab.shape[0]
        idx = tok - coll.linear_index(mesh, tp) * v_loc
        hit = (idx >= 0) & (idx < v_loc)
        rows = torch.where(hit[..., None], tab[idx.clamp(0, v_loc - 1)], 0)
        return coll.all_reduce(rows, mesh, tp) if tp else rows

    return shard_map_compat(local, mesh=mesh, in_specs=((tp[0] if tp else None, None), t_spec),
                            out_specs=t_spec + (None,))(table, tokens)


def vocab_log_prob(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)`` at ``labels`` (logits [B, S, V], labels [B,
    S]).  On DTensor logits, a vocab-parallel log-softmax under
    :func:`shard_map_compat` on their ``("dp", None, "tp")`` layout: each
    rank's max (no gradient) and sum of ``exp`` over its vocab columns,
    all-reduced with max and sum over 'model', and the label's logit
    picked by the rank whose columns hold it, all-reduced with sum; no
    rank gathers the vocab.  Plain tensors take ``torch.log_softmax``."""
    if not _is_dtensor(logits):
        return torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None].long())[..., 0]
    from . import collectives as coll

    mesh, tp = _vocab_split(logits, -1)
    labels = _replicated(labels, mesh)
    b_spec = (make_context(mesh).dp_spec(logits.shape[0]), None)

    def local(x, lab):
        v_loc = x.shape[-1]
        m = x.detach().amax(-1)
        if tp:
            m = coll.all_reduce(m, mesh, tp, op="max")
        shifted = x - m[..., None]
        se = shifted.exp().sum(-1)
        idx = lab.long() - coll.linear_index(mesh, tp) * v_loc
        hit = (idx >= 0) & (idx < v_loc)
        picked = torch.where(hit, shifted.gather(-1, idx.clamp(0, v_loc - 1)[..., None])[..., 0], 0)
        if tp:
            se, picked = coll.all_reduce(se, mesh, tp), coll.all_reduce(picked, mesh, tp)
        return picked - torch.log(se)

    return shard_map_compat(local, mesh=mesh, in_specs=(b_spec + (tp[0] if tp else None,), b_spec),
                            out_specs=b_spec)(logits, labels)
