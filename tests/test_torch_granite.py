"""Granite-4.0-H in the port (``repro_torch``): Mamba-2 and NoPE attention
layers, each followed by a routed MoE beside a shared expert, this device's
share of the experts held and dispatched dropless, held to the benchmark's
plain reference (``portbench/reference/granite_hybrid.py``) on the CPU.

Small widths (``configs.get_smoke("granite-4.0-h-small")``: 3 layers, d 64,
8 experts of which 4 held, top 3), weights from a seeded generator, the
norms perturbed so that each 1 + gamma counts.  The JAX package has no such
architecture: nothing here imports it.
"""

import dataclasses
import sys
import threading
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import granite_hybrid as ref  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.autodiff import tree_map, value_and_grad  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import lm, moe, ssm  # noqa: E402
from repro_torch.models.bridge import flatten  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: E402

torch.set_num_threads(1)

SMOKE = get_smoke("granite-4.0-h-small")
S = 32  # two SSD chunks of 16
OPT = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
NAMES = {"ssm_moe": "mamba", "attn_moe": "attention"}


def _ref_cfg(cfg) -> dict:
    """The reference's view of a port configuration (the keys of the
    benchmark's configuration file)."""
    m, s = cfg.moe, cfg.ssm
    return {
        "hidden_size": cfg.d_model, "vocab_size": cfg.vocab, "rms_norm_eps": cfg.norm_eps,
        "layer_types": [NAMES[k] for k in cfg.block_types()],
        "mamba_n_heads": s.expand * cfg.d_model // s.head_dim, "mamba_d_head": s.head_dim,
        "mamba_d_state": s.d_state, "mamba_d_conv": s.d_conv, "mamba_chunk_size": s.chunk,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
        "attention_multiplier": cfg.attn_scale, "router_experts": m.num_experts,
        "num_experts_per_tok": m.top_k, "router_aux_loss_coef": m.aux_loss_coef,
        "residual_multiplier": cfg.residual_scale, "embedding_multiplier": cfg.embed_scale,
        "logits_scaling": 1.0 / cfg.logits_scale,
    }


def _params(cfg, dtype, seed=0):
    """The port's tree, the norms perturbed (gamma drawn, std 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    tree = lm.init(cfg, gen, device="cpu", dtype=dtype)

    def perturb(path, t):
        if path.rsplit("/", 1)[-1] in ("norm1", "norm2", "final_norm", "norm"):
            t.add_(0.1 * torch.randn(t.shape, generator=gen).to(t.dtype))

    for path, t in flatten(tree).items():
        perturb(path, t)
    return tree


def _batch(cfg, seed=1, rows=2):
    gen = torch.Generator().manual_seed(seed)
    t = torch.randint(0, cfg.vocab, (rows, S + 1), generator=gen)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _port_grads(cfg, params, batch):
    (loss, _), grads = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))(params, batch)
    return float(loss), grads


def _ref_grads(cfg, params, batch):
    leaves = {k: v.float().detach().requires_grad_() for k, v in flatten(params).items()}
    loss = ref.loss(leaves, batch["tokens"], batch["labels"], _ref_cfg(cfg))
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in leaves.items()}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


# Tolerances.  f32: the two sides differ by summation order alone (observed
# over 6 seeds: loss 2e-7, gradients rel L2 under 4.6e-6 by leaf; AdamW on
# the same gradients 3.5e-7 of |p| + lr).  bf16, with every expert picked
# (top_k = num_experts, so no router near-tie can flip between the sides,
# which at random init moves whole gradients: moonshot's SMOKE gradients in
# bf16 lie 0.15-0.25 from its f32 ones): every activation and product is
# rounded to 8 bits (2^-8 = 4e-3 a rounding) over three layers and a
# backward (observed over 8 seeds: loss 3.4e-6, the whole gradient 0.030-
# 0.045 rel L2, a leaf up to 0.104, the per-head sums dt_bias, a_log and
# d_skip); AdamW on the same gradients to one bf16 ulp (2^-7) of |p| + lr:
# the sides round their f32 updates to neighbouring bf16 values.
TOL = {"float32": (1e-5, 1e-4, 1e-4, 2e-6), "bfloat16": (1e-4, 0.08, 0.2, 2 ** -7)}


def _whole_rel(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    return (num / sum(float((want[k].double() ** 2).sum()) for k in want)) ** 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_gradients_and_adamw_match_the_reference(dtype):
    """The port's loss and each leaf's gradient against the reference's in
    f32 from the same weights; then one AdamW step of each side's optimizer
    on the port's gradients."""
    cfg = SMOKE.with_(dtype=dtype, remat="full")
    if dtype == "bfloat16":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.num_experts))
    params = _params(cfg, getattr(torch, dtype))
    batch = _batch(cfg)
    loss_tol, whole_tol, leaf_tol, step_tol = TOL[dtype]
    got_loss, grads = _port_grads(cfg, params, batch)
    want_loss, want = _ref_grads(cfg, params, batch)
    assert abs(got_loss - want_loss) <= loss_tol * abs(want_loss)
    got = flatten(grads)
    assert set(got) == set(want)
    assert _whole_rel(got, want) <= whole_tol
    worst = max((_rel(got[k], want[k]), k) for k in want)
    assert worst[0] <= leaf_tol, worst
    ref_params = {k: v.clone() for k, v in flatten(params).items()}
    grads = tree_map(lambda g: g.float(), grads)
    adam = AdamWConfig(**OPT)
    new = flatten(adamw_update(grads, adamw_init(params, adam), params, adam)[0])
    ref.AdamW(ref_params, **OPT).step(ref_params, flatten(grads))
    for k, v in new.items():
        assert v.dtype == ref_params[k].dtype, k
        gap = (v.double() - ref_params[k].double()).abs()
        assert bool((gap <= step_tol * (ref_params[k].double().abs() + OPT["lr"])).all()), k


def _moe_case(cfg, seed=3, t=48):
    """An uncut MoE layer's weights (all experts), its input [1, t, d]."""
    full = cfg.with_(moe=dataclasses.replace(cfg.moe, experts_held=0), dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    p = moe.moe_params(gen, full, dtype=torch.float32, device=torch.device("cpu"))
    x = torch.randn(1, t, cfg.d_model, generator=gen)
    return full, p, x


def _held_share(cfg, p, first, count):
    """The device holding experts ``[first, first + count)`` of the uncut
    layer: a device holds ids 0 to count - 1, so the router's columns turn
    by ``first`` (which moves no token's picks) to make those experts its
    first."""
    share = cfg.with_(moe=dataclasses.replace(cfg.moe, experts_held=count, dropless=True))
    sl = slice(first, first + count)
    return share, {**p, "router": p["router"].roll(-first, 1),
                   "w1": p["w1"][sl], "w3": p["w3"][sl], "w2": p["w2"][sl]}


def _apply(cfg, p, x):
    top_i, top_w, _ = moe.route(p["router"], x, cfg.moe)
    return moe.moe_apply(p, x, top_i, top_w, cfg)


@pytest.mark.parametrize("shares", [1, 2, 4, 8])
def test_held_shares_add_up_to_the_uncut_layer(shares):
    """Each of ``shares`` devices holds 8 / shares of the 8 experts; their
    partial outputs, the shared expert (which every device computes alike)
    counted once, add up to the reference's uncut layer."""
    full, p, x = _moe_case(SMOKE)
    e = full.moe.num_experts
    shared = (F.silu(x @ p["ws1"]) * (x @ p["ws3"])) @ p["ws2"]
    total = -(shares - 1) * shared
    for r in range(shares):
        total = total + _apply(*_held_share(full, p, r * e // shares, e // shares), x)
    rcfg = _ref_cfg(full)
    want, _ = ref._moe(x, {k: v for k, v in p.items()}, rcfg, "f32")
    assert torch.allclose(total, want, rtol=1e-5, atol=1e-5)
    if shares > 1:  # one share alone is not the layer
        assert not torch.allclose(_apply(*_held_share(full, p, 0, e // shares), x), want, atol=1e-3)


def _counts() -> dict:
    return {"calls": moe.calls.read(), "rows_held": moe.rows_held.read(),
            "rows_max": moe.rows_max.read(), "dropped": moe.dropped.read()}


def _reset():
    for c in (moe.calls, moe.rows_held, moe.rows_max, moe.dropped, ssm.chunks):
        c.reset()


def test_dropless_computes_every_pick_on_one_held_expert():
    """Every token picks held expert 1 first: dropless dispatch computes all
    of them (``moe.dropped`` 0) and equals the oracle; the capacity path at
    1.25 drops the pairs past its buffer and counts them."""
    full, p, x = _moe_case(SMOKE)
    share, sp = _held_share(full, p, 0, 4)
    t, k = x.shape[1], share.moe.top_k
    gen = torch.Generator().manual_seed(5)
    others = torch.stack([torch.randperm(6, generator=gen)[: k - 1] + 2 for _ in range(t)])
    top_i = torch.cat([torch.ones(t, 1, dtype=torch.long), others], 1)[None]  # [1, t, k]
    top_w = torch.softmax(torch.randn(1, t, k, generator=gen), -1)
    w_full = (F.one_hot(top_i, 8)[..., :4] * top_w[..., None]).sum(-2)  # [1, t, 4 held]
    y = torch.einsum("bsd,edf->bsef", x, sp["w1"])
    y = torch.einsum("bsef,efd->bsed", F.silu(y) * torch.einsum("bsd,edf->bsef", x, sp["w3"]),
                     sp["w2"])
    want = torch.einsum("bsed,bse->bsd", y, w_full) + \
        (F.silu(x @ sp["ws1"]) * (x @ sp["ws3"])) @ sp["ws2"]
    _reset()
    got = moe.moe_apply(sp, x, top_i, top_w, share)
    held = int((top_i < 4).sum())
    assert _counts() == {"calls": 1, "rows_held": held, "rows_max": t, "dropped": 0}
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    capped = share.with_(moe=dataclasses.replace(share.moe, dropless=False, capacity_factor=1.25))
    _reset()
    moe.moe_apply(sp, x, top_i, top_w, capped)
    cap = -(-t * k * 5 // (8 * 4))  # ceil(t * k / E * 1.25)
    assert _counts()["dropped"] == t - cap > 0


def test_capacity_path_counts_drops_without_a_read(monkeypatch):
    """The capacity path (moonshot's, deepseek's) counts only ``dropped``,
    as one sum where the pairs lie: no host read, nothing else counted."""
    full, p, x = _moe_case(SMOKE)
    share, sp = _held_share(full, p, 0, 4)
    capped = share.with_(moe=dataclasses.replace(share.moe, dropless=False))
    top_i, top_w, _ = moe.route(sp["router"], x, capped.moe)
    reads = []
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    _reset()
    moe.moe_apply(sp, x, top_i, top_w, capped)
    monkeypatch.undo()
    assert reads == []
    t, k = x.shape[1], capped.moe.top_k
    cap = -(-t * k * 5 // (8 * 4))
    loads = torch.bincount(top_i.reshape(-1), minlength=8)[:4]
    assert _counts() == {"calls": 0, "rows_held": 0, "rows_max": 0,
                         "dropped": int((loads - cap).clamp(min=0).sum())}


@pytest.mark.parametrize("fault", ["none", "rotary", "sqrt_head_dim"])
def test_nope_and_the_attention_scale(fault):
    """The port's attention gradients equal the reference's in f32 with no
    positional embedding and the softmax scale ``attn_scale``; a rotary
    embedding, or the usual 1/sqrt(head_dim) scale, moves them past the f32
    tolerance (the loss at random init hardly sees one attention layer)."""
    cfg = SMOKE.with_(dtype="float32")
    params = _params(cfg, torch.float32)
    batch = _batch(cfg)
    _, want = _ref_grads(cfg, params, batch)
    faulty = {"none": cfg, "rotary": cfg.with_(nope=False),
              "sqrt_head_dim": cfg.with_(attn_scale=0.0)}[fault]
    got = flatten(_port_grads(faulty, params, batch)[1])
    attn = [k for k in want if "/attn/" in k]
    worst = max(_rel(got[k], want[k]) for k in attn)
    assert (worst <= TOL["float32"][2]) == (fault == "none"), worst


@pytest.mark.parametrize("seq,chunk", [(32, 8), (48, 16), (16, 16)])
def test_reference_ssd_equals_its_recurrence(seq, chunk):
    """The reference's chunked SSD (quadratic form within a chunk, the state
    carried across) equals its own token-by-token recurrence, in f64; and
    the port's mixer scan equals it in f32."""
    gen = torch.Generator().manual_seed(seq + chunk)
    b, h, p, n = 2, 4, 8, 16
    x = torch.randn(b, seq, h, p, generator=gen, dtype=torch.float64)
    dt = torch.rand(b, seq, h, generator=gen, dtype=torch.float64) * 0.2
    a = -torch.arange(1, h + 1, dtype=torch.float64)
    bmat, cmat = (torch.randn(b, seq, n, generator=gen, dtype=torch.float64) for _ in range(2))
    want = ref.ssd_recurrent(x, dt, a, bmat, cmat)
    assert torch.allclose(ref.ssd(x, dt, a, bmat, cmat, chunk), want, rtol=1e-10, atol=1e-12)
    got, _ = ssm._ssd(x.float(), bmat[:, :, None].float(), cmat[:, :, None].float(), dt.float(),
                      a.float(), torch.zeros(h), q=chunk)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_the_forward():
    """Serving reaches the new kinds too: a prefill of the first tokens and
    decode steps through the caches give the forward's logits (f32)."""
    cfg = SMOKE.with_(dtype="float32")
    params = _params(cfg, torch.float32)
    tokens = _batch(cfg)["tokens"]
    full, _ = lm.forward(params, {"tokens": tokens}, cfg)
    p0 = 16  # a whole chunk
    logits, caches = lm.prefill(params, {"tokens": tokens[:, :p0]}, cfg)
    assert torch.allclose(logits[:, 0], full[:, p0 - 1], atol=1e-4)
    caches = lm.pad_caches(caches, cfg, S)
    for pos in range(p0, p0 + 4):
        logits, caches = lm.decode_step(params, tokens[:, pos:pos + 1], caches, pos, cfg)
        assert torch.allclose(logits[:, 0], full[:, pos], atol=1e-4), pos


NEW_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
             "ssm.conv", "ssm.scan", "ssm.gate_norm")


def test_spans_and_counters_without_a_sync(monkeypatch):
    """Under ``recording()`` a training gradient emits the new spans; the
    counters count each layer once (not its recompute) and add no host read:
    the only reads are the dropless dispatch's one a call."""
    cfg = SMOKE.with_(dtype="float32", remat="full")
    params = _params(cfg, torch.float32)
    batch = _batch(cfg)
    reads = []
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    _reset()
    grad = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))
    with spans.recording(), profile(activities=[ProfilerActivity.CPU],
                                    experimental_config=_ExperimentalConfig(
                                        profile_all_threads=True)) as prof:
        grad(params, batch)
    monkeypatch.undo()
    names = {e.name for e in prof.events()}
    assert set(NEW_SPANS) <= names, set(NEW_SPANS) - names
    n_moe = cfg.n_layers  # every layer routes
    # forward and the backward's recompute: one host read each, no more
    assert reads == ["tolist"] * 2 * n_moe, reads
    got = _counts()
    assert got["calls"] == n_moe and got["dropped"] == 0
    # the busiest held expert's rows lie between the mean's and all of them
    assert got["rows_max"] <= got["rows_held"] <= 4 * got["rows_max"] and got["rows_max"] > 0
    assert ssm.chunks.read() == 2 * (S // cfg.ssm.chunk) * 2  # 2 Mamba layers x rows x chunks


def test_counter_is_exact_across_threads():
    """16 threads (more than the cores) add host numbers and tensors into
    one counter with a short switch interval: no add is lost."""
    c = spans.Counter()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(300):
                c.add(1)
                c.add(torch.tensor(2))
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    assert c.read() == 16 * 300 * 3
    c.reset()
    assert c.read() == 0
