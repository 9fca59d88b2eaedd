"""The port's sharding layer (``repro_torch.parallel``, ``launch/mesh.py``,
the engine's cache layout, ``input_specs``, ``init_shapes``) against the
JAX reference, and its expert-parallel MoE, sharded checkpoints and
``launch/train.py --mesh`` on ``gloo`` process groups.

The pure checks give both packages a stand-in mesh whose ``.shape`` maps
axis names to sizes, so the full configs need no devices.  The group
checks run in subprocesses (``tests/_torch_dist.py``), one per rank, each
group with its own timeout.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.configs.base import SHAPES, input_specs as jinput_specs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.layers import split
from repro.parallel import sharding as jsh
from repro.serve import engine as jengine
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import store as tstore
from repro_torch.configs.base import input_specs as tinput_specs
from repro_torch.launch.cells import param_bytes_per_device
from repro_torch.models import lm as tlm
from repro_torch.parallel import sharding as tsh
from repro_torch.serve import engine as tengine

from _torch_dist import run_group

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = list(jconfigs.ARCH_IDS)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}


class _Mesh:
    """Sizes only: what ``spec_for`` and ``cache_pspecs`` read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _leaves(axes_tree, shapes):
    flat_a, treedef = jax.tree_util.tree_flatten_with_path(axes_tree, is_leaf=_is_axes)
    flat_s = treedef.flatten_up_to(shapes)
    return [(jax.tree_util.keystr(p), a, tuple(s.shape)) for (p, a), s in zip(flat_a, flat_s)]


def _contexts(mesh, cfg):
    e = cfg.moe.num_experts if cfg.moe else 0
    return [(jsh.make_context(mesh), tsh.make_context(mesh)),
            (jsh.serve_context(mesh, e), tsh.serve_context(mesh, e))]


# ---------------------------------------------------------------- pure specs
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_reference(arch, mesh):
    """Every leaf of the full config, the training and the serving layout:
    the port's spec is the reference's PartitionSpec entry for entry."""
    cfg = jconfigs.get_config(arch)
    shapes, axes = jlm.init_shapes(cfg)
    m = _Mesh(MESHES[mesh])
    for jctx, tctx in _contexts(m, cfg):
        assert tctx.dp_axes == jctx.dp_axes and tctx.ep_axes == jctx.ep_axes
        for path, a, shape in _leaves(axes, shapes):
            want = tuple(jsh.spec_for(a, jctx, shape))
            assert tsh.spec_for(a, tctx, shape) == want, (path, a, shape)
            assert tsh.spec_for(a, tctx) == tuple(jsh.spec_for(a, jctx)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch):
    """Batch 128, cache 32768, on 16x16 and 2x16x16, both layouts."""
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for mesh in ("16x16", "2x16x16"):
        for jctx, tctx in _contexts(_Mesh(MESHES[mesh]), cfg):
            want = jax.tree.map(tuple, jengine.cache_pspecs(cfg, jctx, 128, 32768),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert tengine.cache_pspecs(tcfg, tctx, 128, 32768) == want, mesh


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    for sh in SHAPES.values():
        want = jinput_specs(jconfigs.get_config(arch), sh)
        got = tinput_specs(tconfigs.get_config(arch), sh)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape, (sh.name, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), (sh.name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_axes_match_reference(arch):
    jshapes, jaxes = jlm.init_shapes(jconfigs.get_config(arch))
    tshapes, taxes = tlm.init_shapes(tconfigs.get_config(arch))
    want = {p: (a, s) for p, a, s in _leaves(jaxes, jshapes)}
    got = {}
    flat_t = jax.tree_util.tree_flatten_with_path(tshapes)[0]
    flat_a = jax.tree_util.tree_flatten_with_path(taxes, is_leaf=_is_axes)[0]
    for (p, t), (_, a) in zip(flat_t, flat_a):
        assert t.device.type == "meta"
        got[jax.tree_util.keystr(p)] = (a, tuple(t.shape))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_per_device_match_reference(arch):
    """On 16x16 (training layout) each device holds what the reference's
    specs imply: every leaf's bytes over the product of its split axes."""
    cfg = jconfigs.get_config(arch)
    m = _Mesh(MESHES["16x16"])
    jctx = jsh.make_context(m)
    shapes, axes = jlm.init_shapes(cfg)
    want = 0
    sizes = jax.tree.leaves(jax.tree.map(lambda s: s.dtype.itemsize, shapes))
    for (_, a, shape), itemsize in zip(_leaves(axes, shapes), sizes):
        split_n = 1
        for entry in jsh.spec_for(a, jctx, shape):
            for ax in () if entry is None else ((entry,) if isinstance(entry, str) else entry):
                split_n *= m.shape[ax]
        want += int(np.prod(shape)) * itemsize // split_n
    assert param_bytes_per_device(tconfigs.get_config(arch), tsh.make_context(m)) == want


def test_placements_split_major_axis_first():
    from torch.distributed.tensor import Replicate, Shard

    m = _Mesh(MESHES["2x16x16"])
    assert tsh.placements_for((("pod", "data"), None, "model"), m) == [Shard(0), Shard(0), Shard(2)]
    assert tsh.placements_for((None,), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements_for((("data", "pod"),), m)


def test_mesh_free_context_leaves_tensors():
    ctx = tsh.make_context(None)
    x = torch.ones(4, 2)
    assert tsh.constrain(x, ctx, ("dp", None)) is x
    assert tsh.distribute_tree({"a": x}, None) == {"a": x}
    assert tengine.jit_decode_step(tconfigs.get_smoke("phi4-mini-3.8b"), ctx) is not None


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        make_debug_mesh(2, 2, pod=2)


# ------------------------------------------------------------- gloo groups
def _moe_payload(cf):
    arch = "moonshot-v1-16b-a3b"
    jcfg = jconfigs.get_smoke(arch)
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    jp, _ = split(jmoe.moe_params(jax.random.key(0), jcfg))
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    r = np.random.default_rng(1)
    x = (r.standard_normal((4, 16, jcfg.d_model)) * 0.5).astype(np.float32)
    top_i, top_w, _ = jmoe.route(jp["router"], x, jcfg.moe)
    return {"arch": arch, "cf": cf, "mesh": (2, 2, 0), "moe": _flatten(jp), "x": x,
            "top_i": np.asarray(top_i).astype(np.int64), "top_w": np.asarray(top_w, np.float32)}


@pytest.mark.parametrize("cf", [8.0, 1.0, 1e-6])
def test_moe_apply_layouts_drop_the_same_pairs(cf, tmp_path):
    """On 2x2: the serving layout (full EP over data x model, tokens
    gathered) equals the one-device dispatch over all tokens; the training
    layout (experts over 'model') equals it over each data shard's tokens,
    whose capacity is the shard's, as in the reference's ``shard_map``.
    At cf 1e-6 every expert keeps one pair, so the drops decide the sum."""
    out = run_group(4, "_torch_dist:moe_worker", _moe_payload(cf), tmp_path)
    assert out["serve_ep_axes"] == ("data", "model") and out["train_ep_axes"] == ("model",)
    np.testing.assert_allclose(out["serve"], out["whole"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out["train"], np.concatenate(out["per_shard"]),
                               atol=1e-5, rtol=1e-5)
    if cf == 8.0:  # nothing dropped: every layout is the one-device result
        np.testing.assert_allclose(out["train"], out["whole"], atol=1e-5, rtol=1e-5)


def test_vocab_parallel_lookup_and_log_prob(tmp_path):
    """On 2x2: ``vocab_lookup`` (the table split over 'model' by rows,
    the tokens over 'data') and ``vocab_log_prob`` (logits split over
    'model' by vocab): values and gradients within 1e-5 of the unsharded
    port's and 1e-4 of the reference's (``jnp.take``; ``log_softmax`` and
    ``take_along_axis``); the table's gradient keeps its rows over 'model'
    (not summed there).  A vocab that 'model' does not divide and a label
    outside the vocabulary raise."""
    import jax.numpy as jnp

    r = np.random.default_rng(5)
    v, d = 256, 16
    payload = {"mesh": (2, 2, 0),
               "table": r.standard_normal((v, d)).astype(np.float32),
               "tokens": r.integers(0, v, (4, 12)).astype(np.int64),
               "logits": r.standard_normal((4, 6, v)).astype(np.float32) * 3,
               "labels": r.integers(0, v, (4, 6)).astype(np.int64)}
    out = run_group(4, "_torch_dist:vocab_worker", payload, tmp_path)

    def ref_lookup(t, i):
        return jnp.take(t, i, axis=0)

    def ref_log_prob(x, i):
        return jnp.take_along_axis(jax.nn.log_softmax(x, -1), i[..., None], -1)[..., 0]

    for name, fn, x, idx in (("lookup", ref_lookup, "table", "tokens"),
                             ("log_prob", ref_log_prob, "logits", "labels")):
        got = out[name]
        xs, ids = jnp.asarray(payload[x]), jnp.asarray(payload[idx])
        want = fn(xs, ids)
        want_g = jax.grad(lambda a: (fn(a, ids) ** 2).sum())(xs)
        np.testing.assert_allclose(got["sharded"], got["plain"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["grad"], got["grad_plain"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["sharded"], want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["grad"], want_g, atol=1e-4, rtol=1e-4)
    # ("data", "model"): summed over the data shards' tokens, rows over 'model'
    assert out["lookup"]["grad_placements"][1] == "Shard(dim=0)"
    errs = out["errors"]
    assert "does not split over 'model'" in errs["lookup"]
    assert "does not split over 'model'" in errs["log_prob"]
    assert "outside the vocabulary" in errs["label"]


def test_restore_with_shardings_round_trips(tmp_path):
    """A checkpoint saved whole restores onto a 2x2 mesh's layout (some
    leaves split), and the pieces put together are the saved bits."""
    arch = "phi4-mini-3.8b"
    params = tlm.init(tconfigs.get_smoke(arch), torch.Generator().manual_seed(0), device="cpu")
    tstore.save(str(tmp_path / "ck"), 3, params)
    out = run_group(4, "_torch_dist:restore_worker",
                    {"arch": arch, "mesh": (2, 2, 0), "dir": str(tmp_path / "ck")}, tmp_path)
    assert out["step"] == 3 and out["sharded"] > 0
    from repro_torch.models.bridge import flatten

    for k, v in flatten(params).items():
        assert np.array_equal(out["leaves"][k], v.view(torch.int16).numpy()), k


def test_launch_train_mesh_on_gloo(tmp_path):
    """``launch/train.py --mesh 2x2`` on four gloo ranks (``torchrun``'s
    environment): trains, checkpoints, and resumes into the mesh."""
    ck = str(tmp_path / "ck")
    argv = ["-m", "repro_torch.launch.train", "--arch", "phi4-mini-3.8b", "--device", "cpu",
            "--smoke", "--mesh", "2x2", "--batch", "4", "--seq", "16", "--ckpt", ck,
            "--ckpt-every", "2"]

    def run(steps):
        with socket.socket() as sock:  # a port that is free now, not a fixed one
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="4")
        procs = [subprocess.Popen([sys.executable, *argv, "--steps", str(steps)],
                                  env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(4)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=240))
        finally:
            for p in procs:
                p.kill()
        assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
        return outs[0][0]

    out = run(2)
    assert out.count("loss") == 2 and "done" in out
    assert tstore.latest_step(ck) == 2
    out = run(3)
    assert "resumed from step 2" in out and out.count("loss") == 1
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert all(np.isfinite(losses))
