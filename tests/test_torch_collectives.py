"""The port's collectives over several mesh axes (``repro_torch.parallel.
collectives``) against the reference's ``lax`` collectives over the same
tuple of axes, on eight ``gloo`` ranks of a 2x2x2 ("pod", "data", "model")
mesh (``tests/_torch_dist.py::collectives_worker``).

Each rank holds one row of the same numpy input.  The reference runs in a
subprocess on 8 forced host devices under ``shard_map``: ``psum``, ``pmax``,
``all_gather(tiled=True)`` and a sum of squares that each device uses on
its own row, each with ``jax.vjp`` of the same cotangents.  A collective
over several axes must be one collective over their flattened group, as
``lax.psum`` over a tuple is one: the counting dispatch mode
(``launch/op_analysis.py``) sees one call.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from _torch_dist import run_group

ROOT = Path(__file__).resolve().parent.parent
AXES = [("data", "model"), ("pod", "data"), ("pod", "model"), ("pod", "data", "model"),
        ("model",)]
TOL = 1e-6  # f32 sums over 2-8 ranks in another order, relative to the result's largest

_REFERENCE = textwrap.dedent(
    r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.parallel.sharding import shard_map_compat

    names = ("pod", "data", "model")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), names)
    r = np.random.default_rng(0)
    x = r.standard_normal((8, 3, 4)).astype(np.float32)
    rows = P(names)
    out = {{"x": x, "cases": {{}}, "want": {{}}}}
    for axes in {axes!r}:
        rest = P(tuple(a for a in names if a not in axes) or None)
        fns = {{"sum": (lambda b: jax.lax.psum(b, axes), rest),
                "max": (lambda b: jax.lax.pmax(b, axes), rest),
                "gather": (lambda b: jax.lax.all_gather(b, axes, tiled=True), rows),
                "shares": (lambda b: b * jax.lax.psum(jnp.sum(b * b), axes), rows)}}
        cases = out["cases"][axes] = {{}}
        for op, (f, spec) in fns.items():
            g = shard_map_compat(f, mesh=mesh, in_specs=rows, out_specs=spec)
            if op == "max":  # pmax takes no gradient
                out["want"][(axes, op)] = {{"y": np.asarray(g(jnp.asarray(x)))}}
                continue
            y, vjp = jax.vjp(g, jnp.asarray(x))
            want = {{"y": np.asarray(y)}}
            ct = r.standard_normal(y.shape).astype(np.float32)
            cases[op] = ct
            want["grad"] = np.asarray(vjp(jnp.asarray(ct))[0])
            out["want"][(axes, op)] = want
    with open({out!r}, "wb") as f:
        pickle.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("coll_ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = _REFERENCE.format(src=str(ROOT / "src"), axes=AXES, out=str(path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    return run_group(8, "_torch_dist:collectives_worker",
                     {"x": reference["x"], "cases": reference["cases"]},
                     tmp_path_factory.mktemp("coll_ranks"))


def _blocks(ranks, axes, op, key):
    return [r[(axes, op)][key] for r in ranks]


@pytest.mark.parametrize("axes", AXES, ids="-".join)
@pytest.mark.parametrize("op", ["sum", "max", "gather"])
def test_collective_matches_reference(ranks, reference, axes, op):
    """``all_reduce`` (sum, max) and ``all_gather`` over ``axes`` give every
    rank its block of the reference's result, major axis first for the
    gather, and run as one collective however many axes they span."""
    want = reference["want"][(axes, op)]["y"]
    names = ("pod", "data", "model")
    for rank, got in enumerate(_blocks(ranks, axes, op, "y")):
        coord = np.unravel_index(rank, (2, 2, 2))
        if op == "gather":
            blk = rank
        else:  # the result varies over the other axes only
            rest = [i for i, a in enumerate(names) if a not in axes]
            blk = int(np.ravel_multi_index([coord[i] for i in rest], [2] * len(rest))) \
                if rest else 0
        n = got.shape[0]
        np.testing.assert_allclose(got, want[blk * n:(blk + 1) * n], rtol=TOL,
                                   atol=TOL * np.abs(want).max(), err_msg=f"rank {rank}")
    kind = "all-gather" if op == "gather" else "all-reduce"
    assert all(c == {kind: 1} for c in _blocks(ranks, axes, op, "fwd"))


@pytest.mark.parametrize("axes", AXES, ids="-".join)
@pytest.mark.parametrize("op", ["sum", "gather", "shares"])
def test_collective_gradient_matches_reference(ranks, reference, axes, op):
    """Gradients, each rank's row against the reference's ``jax.vjp`` of
    the same cotangents: the sum's passes through (its result is used
    whole, the same on every rank of the group), the gather's comes back
    reduce-scattered, and ``sum_shares``' is summed over the group (each
    rank uses the sum with its own row: ``lax.psum`` of a varying value)."""
    want = reference["want"][(axes, op)]["grad"]
    for rank, got in enumerate(_blocks(ranks, axes, op, "grad")):
        np.testing.assert_allclose(got, want[rank:rank + 1], rtol=TOL,
                                   atol=TOL * np.abs(want).max(), err_msg=f"rank {rank}")
    bwd = {"sum": {}, "gather": {"reduce-scatter": 1}, "shares": {"all-reduce": 1}}[op]
    assert all(c == bwd for c in _blocks(ranks, axes, op, "bwd"))
