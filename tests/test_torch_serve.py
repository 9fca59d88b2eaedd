"""The port's serving path (``repro_torch.serve``, ``repro_torch.launch.serve``)
against the JAX reference on the CPU: the device-plane step makers, greedy
generation, the host plane copied byte for byte, and the continuous-batching
pool serving real (SMOKE-size) torch replicas."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.checkpoint.store import _flatten, _path_str
from repro.configs import get_smoke as jget_smoke
from repro.launch import serve as jlaunch
from repro.models import lm as jlm
from repro.parallel.sharding import ParallelContext
from repro.serve import engine as jengine
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.bridge import flatten, params_from_flat
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import Replica, ServePool

# SMOKE-size tensors: one intra-op thread is as fast, and leaves the other
# test workers' cores (and their timing-sensitive threads) alone.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "phi4-mini-3.8b"
MOE = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
RECURRENT = ["mamba2-2.7b", "recurrentgemma-2b"]


def _f32_models(arch=ARCH):
    jcfg = jget_smoke(arch).with_(dtype="float32")
    tcfg = get_smoke(arch).with_(dtype="float32")
    jp, _ = jlm.init(jcfg, jax.random.key(0))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, jp)
    return jcfg, tcfg, jp, params_from_flat(_flatten(jp), device="cpu", dtype=torch.float32)


def test_host_plane_is_byte_identical():
    """From ``def request_size`` to the end of the file the port's engine is
    the reference's code, byte for byte."""
    ours = (ROOT / "src" / "repro_torch" / "serve" / "engine.py").read_bytes()
    theirs = (ROOT / "src" / "repro" / "serve" / "engine.py").read_bytes()
    mark = b"def request_size("
    assert ours.count(mark) == theirs.count(mark) == 1
    assert ours[ours.index(mark):] == theirs[theirs.index(mark):]


def test_exports_are_the_references_minus_cache_sharding():
    """The cache sharding came with the parallel slice: nothing is missing."""
    assert set(tserve.__all__) == set(jserve.__all__)
    assert set(tengine.__all__) == set(jengine.__all__)


def test_abstract_caches_match_reference_shapes():
    _check_abstract_caches(ARCH)


@pytest.mark.parametrize("arch", MOE)
def test_moe_abstract_caches_match_reference_shapes(arch):
    """moonshot's GQA K/V and deepseek's MLA ``c``/rope-key caches, for its
    dense and MoE layer groups alike."""
    _check_abstract_caches(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_abstract_caches_match_reference_shapes(arch):
    """The reference's shapes and dtypes: a ``local`` block's ring is
    window-sized whatever the cache length, the SSM state is f32
    ``[L, B, H, P, N]``, the RG-LRU state f32 ``[L, B, W]``, and the conv
    tails are in the activation dtype (bf16)."""
    ours = _check_abstract_caches(arch, cache_len=50)
    cfg = get_smoke(arch)
    for k, t in ours.items():  # k: "group/block-in-group/leaf"
        if arch == "mamba2-2.7b":
            s = cfg.ssm
            h = s.expand * cfg.d_model // s.head_dim
            state = (cfg.n_layers, 3, h, s.head_dim, s.d_state)
            conv = (cfg.n_layers, 3, s.d_conv - 1, s.expand * cfg.d_model + 2 * s.d_state)
        else:
            count = t.shape[0]
            ring = (count, 3, cfg.window, cfg.n_kv_heads, cfg.head_dim_)
            state = (count, 3, cfg.rglru.lru_width)
            conv = (count, 3, cfg.rglru.d_conv - 1, cfg.rglru.lru_width)
            if k.startswith("0/2/"):  # the cycle's local block
                assert tuple(t.shape) == ring and cfg.window < 50, k
                continue
        want = {"0": (state, torch.float32), "1": (conv, torch.bfloat16)}[k[-1]]
        assert (tuple(t.shape), t.dtype) == want, k


@pytest.mark.parametrize("enc_len", [None, 30])
def test_encdec_abstract_caches_match_reference_shapes(enc_len):
    """seamless's ``(self K/V, memory K/V)`` pairs, the memory ``[L, B,
    enc_len, Hkv, hd]`` (``enc_len`` defaults to the cache length)."""
    ours = _check_abstract_caches("seamless-m4t-medium", enc_len=enc_len)
    cfg = get_smoke("seamless-m4t-medium")
    assert set(ours) == {"0/0/0/0", "0/0/0/1", "0/0/1/0", "0/0/1/1"}
    for k, t in ours.items():  # k: "group/block/pair half/leaf"
        s = 20 if k.startswith("0/0/0/") else (enc_len or 20)
        assert tuple(t.shape) == (cfg.n_layers, 3, s, cfg.n_kv_heads, cfg.head_dim_), k


def _check_abstract_caches(arch, cache_len=20, enc_len=None):
    """The port's ``abstract_caches`` against the reference's: paths,
    shapes and dtypes."""
    cfg = get_smoke(arch)
    ours = flatten(tengine.abstract_caches(cfg, 3, cache_len, enc_len))
    theirs = {
        "/".join(_path_str(p) for p in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            jengine.abstract_caches(jget_smoke(arch), 3, cache_len, enc_len))[0]
    }
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == str(theirs[k].dtype), k
    return ours


def test_step_makers_match_reference():
    """jit_prefill_step / jit_decode_step against the reference's jitted
    steps, f32 (atol = rtol = 1e-4)."""
    jcfg, tcfg, jp, tp = _f32_models()
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 7)).astype(np.int32)
    jpre = jengine.jit_prefill_step(jcfg, _NoMesh(), None)
    jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tengine.jit_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    jc, tc = jlm.pad_caches(jc, jcfg, 9), tlm.pad_caches(tc, tcfg, 9)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jdec = jengine.jit_decode_step(jcfg, _NoMesh(), 2, 9)
    jl2, _ = jdec(jp, jnp.asarray(nxt), jc, jnp.int32(7))
    tl2, tc2 = tengine.jit_decode_step(tcfg)(tp, torch.from_numpy(nxt).long(), tc, 7)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4, rtol=1e-4)
    assert tc2 is tc  # the port's donation: updated in place


class _NoMesh:
    mesh = None


def test_step_makers_take_a_mesh_free_context():
    """A context without a mesh gives the plain steps (with a mesh:
    ``tests/test_torch_sharded_steps.py``); ``cache_pspecs`` needs one."""
    cfg = get_smoke(ARCH).with_(dtype="float32")
    params = tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(1))
    wl, wc = tlm.prefill(params, {"tokens": toks}, cfg)
    gl, gc = tengine.jit_prefill_step(cfg, _NoMesh(), {"tokens": toks})(params, {"tokens": toks})
    assert torch.equal(gl, wl)
    step = tengine.jit_decode_step(cfg, _NoMesh(), 2, 5)
    wc, gc = tlm.pad_caches(wc, cfg, 6), tlm.pad_caches(gc, cfg, 6)
    assert torch.equal(step(params, toks[:, :1], gc, 5)[0],
                       tlm.decode_step(params, toks[:, :1], wc, 5, cfg)[0])
    with pytest.raises(ValueError, match="needs a context with a mesh"):
        tengine.cache_pspecs(cfg, _NoMesh(), 2, 5)


def test_generate_matches_reference():
    """Greedy generation, 3 prompts of phi4 SMOKE in f32: the same tokens as
    ``repro.launch.serve.generate``."""
    jcfg, tcfg, jp, tp = _f32_models()
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab, (3, 9)).astype(np.int32)
    want = np.asarray(jlaunch.generate(jcfg, jp, jnp.asarray(prompts), 6))
    got = tlaunch.generate(tcfg, tp, torch.from_numpy(prompts).long(), 6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    gen = tlaunch.make_replica_generate(tcfg, tp, 6)
    for row, prompt in zip(want, prompts):
        assert gen({"tokens": prompt})["completion"] == row.tolist()


@pytest.mark.parametrize("arch", MOE)
def test_moe_generate_matches_reference(arch):
    """Greedy generation of moonshot and deepseek SMOKE in f32 through the
    step makers: the same tokens as the reference's ``generate``, and the
    jitted steps' logits within 1e-4."""
    jcfg, tcfg, jp, tp = _f32_models(arch)
    prompts = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 7)).astype(np.int32)
    want = np.asarray(jlaunch.generate(jcfg, jp, jnp.asarray(prompts), 5))
    got = tlaunch.generate(tcfg, tp, torch.from_numpy(prompts).long(), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    ctx = ParallelContext(mesh=None)  # the reference's MoE reads its axes
    jl, jc = jengine.jit_prefill_step(jcfg, ctx, None)(jp, {"tokens": jnp.asarray(prompts)})
    tl, tc = tengine.jit_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    jc, tc = jlm.pad_caches(jc, jcfg, 8), tlm.pad_caches(tc, tcfg, 8)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, _ = jengine.jit_decode_step(jcfg, ctx, 2, 8)(jp, jnp.asarray(nxt), jc, jnp.int32(7))
    tl2, _ = tengine.jit_decode_step(tcfg)(tp, torch.from_numpy(nxt).long(), tc, 7)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_generate_matches_reference(arch):
    """Greedy generation of mamba2 and recurrentgemma SMOKE in f32, 3
    prompts of 9 + 8 tokens (recurrentgemma past no window here: the
    window's wrap is held in tests/test_torch_models.py): the same tokens
    as the reference's ``generate``, whose completions the port therefore
    shares, repetitions included."""
    jcfg, tcfg, jp, tp = _f32_models(arch)
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab, (3, 9)).astype(np.int32)
    want = np.asarray(jlaunch.generate(jcfg, jp, jnp.asarray(prompts), 8))
    got = tlaunch.generate(tcfg, tp, torch.from_numpy(prompts).long(), 8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    gen = tlaunch.make_replica_generate(tcfg, tp, 8)
    assert gen({"tokens": prompts[1]})["completion"] == want[1].tolist()


def test_servepool_streams_across_waves_without_teardown():
    """Mirror of ``tests/test_open_arrival.py``'s test of the same name, on
    the port's ServePool with torch CPU replicas of the SMOKE model: every
    completion equals the request generated alone."""
    cfg = get_smoke(ARCH)
    params = tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = tlaunch.make_replica_generate(cfg, params, 3)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (24, 5))
    want = [gen({"tokens": p})["completion"] for p in prompts]

    pool = ServePool(
        [Replica("fast", gen), Replica("slow", gen, slow_factor=10.0)],
        seed=3,
    )
    pool.start()
    runtime = pool._runtime
    # wave 1: everything pinned to the SLOW replica post-start; the fast
    # replica can only serve via mid-flight steals.
    futs = pool.submit_wave([{"tokens": p} for p in prompts[:16]], replica=1)
    resp = [f.result(timeout=60) for f in futs]
    assert [r["completion"] for r in resp] == want[:16]
    served_by_fast = sum(1 for f in futs if f.worker == 0)
    assert served_by_fast > 0, "no injected request was stolen cross-replica"
    s1 = pool.stats()
    assert len(s1.steals) > 0

    # wave 2 reuses the same runtime: no teardown/re-partition between waves
    resp2, s2 = pool.submit_all([{"tokens": p} for p in prompts[16:]])
    assert pool._runtime is runtime
    assert [r["completion"] for r in resp2] == want[16:]
    assert sum(s2.per_worker_tasks) == 24

    final = pool.shutdown()
    assert sum(final.per_worker_tasks) == 24
    assert len(final.latencies) == 24


def _run(args, timeout=120):
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
    )


@pytest.mark.parametrize("mode", [[], ["--open-arrival", "--rate", "40", "--replicas", "2",
                                       "--slow-factor", "4"]])
def test_serve_launcher_runs_on_cpu(mode):
    proc = _run(["-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
                 "--requests", "4", "--prompt-len", "6", "--new-tokens", "3", *mode])
    assert proc.returncode == 0, proc.stderr
    assert "on cpu" in proc.stdout


@pytest.mark.parametrize("arch", MOE + RECURRENT)
def test_moe_serve_launcher_runs_on_cpu(arch):
    proc = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
                 "--requests", "3", "--prompt-len", "5", "--new-tokens", "3",
                 "--open-arrival", "--rate", "40", "--replicas", "2"])
    assert proc.returncode == 0, proc.stderr
    assert "on cpu" in proc.stdout and "requests/replica" in proc.stdout


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b"])
def test_serve_launcher_refuses_non_token_archs(arch):
    """As the reference's launcher: an enc-dec or VLM arch is refused before
    any weight is drawn (their requests carry embeddings, not token ids)."""
    proc = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu"])
    assert proc.returncode != 0
    assert "handles token-in archs" in proc.stderr


def test_serve_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA request is served")
    proc = _run(["-m", "repro_torch.launch.serve", "--arch", ARCH, "--requests", "1"])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_serve_demo_runs_on_cpu():
    proc = _run([str(ROOT / "examples" / "serve_demo_torch.py"), "--device", "cpu",
                 "--arch", ARCH], timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wave 1" in proc.stdout and "wave 2" in proc.stdout
