"""Heterogeneous data-parallel training of a Granite-4.0-H cut (Mamba-2 and
NoPE attention layers, each followed by a routed MoE beside a shared
expert, this chip's share of the experts held) through the port's
``HetDPTrainer`` over ``lm.loss_fn``: the driver ``hetdp_train`` runs for a
dense model, on another model.

It works as ``hetdp_train`` does (see there): set-up draws every leaf by
its path from the seed, times the pacing, builds one trainer and takes the
first ``check_steps`` steps, which the check follows with the plain
reference (``portbench/reference/granite_hybrid.py``) in float32; the
window hands the trainer more steps; a late step from the window's state is
followed too, twice: on the reference's own expert picks, and on the
program's (``program_routes``; ``late_routed_*`` and ``late_route_flips``,
reported, not compared).  Its numbers add the median leaf's gradient gap
(``compare``): at the late step the worst leaf's reads up to ~1.6 in sound
runs, on the reference's routing or the program's alike, the median leaf's
under 1.5e-3 (``PERF.md`` §2).  Besides, it reads the port's MoE and SSM counters
(``repro_torch.models.moe``, ``repro_torch.models.ssm``): over the window
for the per-layer metrics and ``step_flops`` (``portbench/hybrid_counts.py``),
and over the whole run for the check's ``dropped_picks`` (pairs routed to
a held expert and not computed; 0 under dropless dispatch).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import counts, hybrid_counts
from portbench.drivers import hetdp_train as base
from portbench.reference import granite_hybrid as ref
from repro_torch.autodiff import value_and_grad
from repro_torch.models import lm, moe, ssm
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec

KINDS = {"mamba": "ssm_moe", "attention": "attn_moe"}
# leaves the port stores in float32 whatever the model's dtype
F32 = ("router", "a_log", "dt_bias")
COUNTERS = {"moe.calls": moe.calls, "moe.rows_held": moe.rows_held,
            "moe.rows_max": moe.rows_max, "moe.dropped": moe.dropped, "ssm.chunks": ssm.chunks}


def _read_counters() -> dict[str, float]:
    return {k: c.read() for k, c in COUNTERS.items()}


def leaf_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], object]]:
    """Each leaf's shape and how it is drawn, by its path in the stacked
    tree both the port and the reference read: a std (normal), None
    (zeros), "ones", "a_log" (log 1..heads) or "dt_bias" (the inverse
    softplus of dt drawn log-uniform in [1e-3, 1e-1])."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hd, n, k = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_d_conv"]
    g = cfg["mamba_n_groups"]
    d_in, conv = h * hd, h * hd + 2 * g * n
    ah, akv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ahd = d // ah
    e, f, fs = cfg["num_local_experts"], cfg["intermediate_size"], cfg["shared_intermediate_size"]
    out: dict = {"embed": ((v, d), 0.02), "final_norm": ((d,), None)}
    for gi, (kind, count) in enumerate(ref.runs(cfg["layer_types"])):
        pre = f"groups/{gi}/b0/"
        leaves = {"norm1": ((d,), None), "norm2": ((d,), None),
                  "moe/router": ((d, cfg["router_experts"]), d ** -0.5),
                  "moe/w1": ((e, d, f), d ** -0.5), "moe/w3": ((e, d, f), d ** -0.5),
                  "moe/w2": ((e, f, d), f ** -0.5), "moe/ws1": ((d, fs), d ** -0.5),
                  "moe/ws3": ((d, fs), d ** -0.5), "moe/ws2": ((fs, d), fs ** -0.5)}
        if kind == "mamba":
            leaves.update({
                "ssm/in_proj": ((d, 2 * d_in + 2 * g * n + h), d ** -0.5),
                "ssm/conv_w": ((k, conv), k ** -0.5), "ssm/conv_b": ((conv,), None),
                "ssm/a_log": ((h,), "a_log"), "ssm/dt_bias": ((h,), "dt_bias"),
                "ssm/d_skip": ((h,), "ones"), "ssm/norm": ((d_in,), None),
                "ssm/out_proj": ((d_in, d), d_in ** -0.5)})
        else:
            leaves.update({
                "attn/wq": ((d, ah * ahd), d ** -0.5), "attn/wk": ((d, akv * ahd), d ** -0.5),
                "attn/wv": ((d, akv * ahd), d ** -0.5), "attn/wo": ((ah * ahd, d), (ah * ahd) ** -0.5)})
        out.update({pre + p: ((count, *shape), how) for p, (shape, how) in leaves.items()})
    return out


def make_leaf(cfg: dict, seed: int, path: str, device, dtype) -> torch.Tensor:
    """One leaf, drawn on ``device`` from its own generator (any leaf can
    be drawn again alone) in float32, stored in ``dtype`` (float32 for the
    router, ``a_log`` and ``dt_bias``, as the port keeps them)."""
    shapes = leaf_shapes(cfg)
    shape, how = shapes[path]
    if path.rsplit("/", 1)[-1] in F32:
        dtype = torch.float32
    if how is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    if how == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if how == "a_log":
        return torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)) \
            .expand(shape).to(dtype).contiguous()
    gen = torch.Generator(device=device).manual_seed(base._seed(seed, sorted(shapes).index(path)))
    if how == "dt_bias":
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(how).to(dtype)


def make_params(cfg: dict, seed: int, device, dtype) -> dict:
    """The weights as the port's tree: ``embed``, ``final_norm`` and
    ``groups[g]["b0"]``, one group a run of one layer kind."""
    tree: dict = {"groups": [{"b0": {}} for _ in ref.runs(cfg["layer_types"])]}
    for path in leaf_shapes(cfg):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node[int(p)] if p.isdigit() else node.setdefault(p, {})
        node[parts[-1]] = make_leaf(cfg, seed, path, device, dtype)
    return tree


def port_config(cfg: dict) -> ModelConfig:
    """The ``repro_torch`` model configuration the file describes: the
    published widths, the cut's layers, this chip's experts held, dropless."""
    d, ah = cfg["hidden_size"], cfg["num_attention_heads"]
    return ModelConfig(
        name=cfg["name"], family="hybrid", n_layers=cfg["num_hidden_layers"], d_model=d,
        n_heads=ah, n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=d // ah,
        layer_types=tuple(KINDS[t] for t in cfg["layer_types"]),
        moe=MoEConfig(num_experts=cfg["router_experts"], top_k=cfg["num_experts_per_tok"],
                      d_expert=cfg["intermediate_size"], num_shared=1,
                      d_shared=cfg["shared_intermediate_size"],
                      aux_loss_coef=cfg["router_aux_loss_coef"],
                      experts_held=cfg["num_local_experts"], dropless=True),
        ssm=SSMConfig(d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                      expand=cfg["mamba_expand"], head_dim=cfg["mamba_d_head"],
                      chunk=cfg["mamba_chunk_size"], n_groups=cfg["mamba_n_groups"]),
        tie_embeddings=cfg["tie_word_embeddings"], norm_eps=cfg["rms_norm_eps"],
        max_seq=cfg["max_position_embeddings"], dtype=cfg["torch_dtype"], remat=cfg["remat"],
        act=cfg["hidden_act"], nope=cfg["position_embedding_type"] == "nope",
        attn_scale=cfg["attention_multiplier"], embed_scale=float(cfg["embedding_multiplier"]),
        residual_scale=cfg["residual_multiplier"], logits_scale=1.0 / cfg["logits_scaling"])


class HetDPTrainHybrid(base.HetDPTrain):
    """One run of the hybrid training cell."""

    def setup(self) -> None:
        for c in COUNTERS.values():
            c.reset()
        cfg, dev = self.cfg, self.device
        pcfg = port_config(cfg)
        self.pcfg = pcfg
        params = make_params(cfg, self.seed, dev, self.dtype)
        loss_fn = lambda p, b: lm.loss_fn(p, b, pcfg)  # noqa: E731
        grad = value_and_grad(loss_fn)
        mb = base.make_batches(cfg, self.traffic, self.seed, -1, dev)[0]
        self.mb_times = []

        def time_grad(p, calls: int) -> float:
            """The median of the pacing's timed calls so far, the first
            (which warms) left out."""
            for _ in range(calls):
                self._sync()
                t0 = time.perf_counter()
                grad(p, mb)
                self._sync()
                self.mb_times.append(time.perf_counter() - t0)
            return float(np.median(self.mb_times[1:]))

        self.mb_s = time_grad(params, 6)
        workers = [WorkerSpec(f"w{i}", slow_factor=f) for i, f in enumerate(self.slowdowns)]
        self.trainer = HetDPTrainer(loss_fn, params, workers, AdamWConfig(**self._opt()),
                                    base_task_time=self.traffic["pace"] * self.mb_s)
        del params
        self.prog = {"losses": []}
        b1 = self.traffic["b1"]
        for step in range(self.limits["check_steps"]):
            m = self.trainer.step(base.make_batches(cfg, self.traffic, self.seed, step, dev))
            self.prog["losses"].append(m["loss"])
            if step == 0:  # the gradient as the optimizer got it, before its clip
                scale = min(1.0, self.traffic["clip_norm"] / max(m["grad_norm"], 1e-9))
                self.prog["grad_norms"] = {k: v / ((1.0 - b1) * scale) for k, v in
                                           base._leaf_norms(self.trainer.opt_state["m"]).items()}
        change = {}
        for k, p in ref.flat_leaves(self.trainer.params).items():
            p0 = make_leaf(cfg, self.seed, k, dev, self.dtype)
            change[k] = float((p.double() - p0.double()).norm())
            del p0
        self.prog["change_norms"] = change
        # the pacing again, from the trained weights with the trainer's state
        # on the card as the window has it, over both sets of calls
        self.mb_s = time_grad(self.trainer.params, 6)
        self.trainer.base_task_time = self.traffic["pace"] * self.mb_s
        self._sync()

    def window(self, seconds: float) -> dict:
        before = _read_counters()
        out = super().window(seconds)
        after = _read_counters()  # the steps have synchronised; outside the timed window
        self.window_counts = {k: after[k] - before[k] for k in after}
        return out

    def counters(self) -> dict:
        """What the readers take: ``hetdp_train``'s keys, a step's model
        flops, and the counters' window sums a step."""
        c, t = self.cfg, self.traffic
        steps = max(len(self.history), 1)
        per_step = {k: v / steps for k, v in self.window_counts.items()}
        stats = self.trainer.history[-len(self.history):] if self.history else []
        return {"pool_stats": stats, "microbatch_s": self.mb_s, "tasks": t["tasks"],
                "slowdowns": self.slowdowns, "pace": t["pace"], "counts": counts,
                "step_flops": hybrid_counts.train_step_flops(
                    c, t["tasks"] * t["rows"], t["seq"], per_step["moe.rows_held"]),
                "moe.experts_held": c["num_local_experts"], **per_step}

    def release(self) -> None:
        super().release()
        self.dropped = moe.dropped.read()

    def _late_step(self) -> None:
        """``hetdp_train``'s late step, with the program's expert picks for
        its microbatches noted first (from the same state, on the same rows)."""
        step = self.limits["check_steps"] + len(self.history)
        batches = base.make_batches(self.cfg, self.traffic, self.seed, step, self.device)
        routes = program_routes(self.trainer.params, batches, self.pcfg)
        super()._late_step()
        self.late["routes"] = routes

    def check(self) -> tuple[int, int, dict]:
        attempted = len(self.history)
        failed = sum(1 for m in self.history
                     if not math.isfinite(m["loss"]) or m["failed_workers"]
                     or sum(m["tasks_per_worker"]) != self.traffic["tasks"])
        cfg, dev = self.cfg, self.device
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            want = reference_readings(cfg, self.traffic, self.seed, self.limits["check_steps"],
                                      dev, self.dtype, self._opt())
            late_want = reference_late(cfg, self.traffic, self.seed, self.late, dev, self._opt())
            routed_want = reference_late(cfg, self.traffic, self.seed, self.late, dev, self._opt(),
                                         routes=self.late["routes"])
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        self.want, self.late_want, self.routed_want = want, late_want, routed_want
        gaps = compare(self.prog, want)
        gaps.update({"late_" + k: v for k, v in compare(self.late, late_want).items()})
        # the late step again, the reference taking the program's expert picks
        # (where bfloat16 and float32 break a router's near-tie apart)
        gaps.update({"late_routed_" + k: v for k, v in compare(self.late, routed_want).items()})
        gaps["late_route_flips"] = float(routed_want["route_flips"])
        gaps["dropped_picks"] = float(self.dropped)
        self.not_compared = {k: v for k, v in gaps.items() if k not in self.limits}
        return attempted, failed, {k: (v, float(self.limits[k])) for k, v in gaps.items()
                                   if k in self.limits}

    def detail(self) -> dict:
        out = super().detail()
        out["window_counters"] = getattr(self, "window_counts", {})
        out["microbatch_times_s"] = self.mb_times
        out["worst_grad_leaves"]["late_routed"] = base.worst_leaves(self.late, self.routed_want)
        return out


def program_routes(params, batches, pcfg) -> list[list[ref.Routed]]:
    """The program's expert picks, one :class:`ref.Routed` a MoE layer, for
    each microbatch: its forward alone from ``params``, without a gradient
    (the same products as the step's), ``moe.route``'s answers noted."""
    picks: list[list] = []
    route = moe.route

    def noting(router_w, x, m):
        out = route(router_w, x, m)
        picks[-1].append(ref.Routed(out[0].detach().to("cpu", copy=True)))
        return out

    moe.route = noting
    try:
        with torch.no_grad():
            for mb in batches:
                picks.append([])
                lm.loss_fn(params, mb, pcfg)
    finally:
        moe.route = route
    return picks


def reference_readings(cfg, traffic, seed, steps, device, dtype, opt, matmul="f32") -> dict:
    """The reference's readings of the first ``steps`` steps from the run's
    weights and rows."""
    params = ref.flat_leaves(make_params(cfg, seed, device, dtype))
    batches = [base.make_batches(cfg, traffic, seed, s, device) for s in range(steps)]
    return ref.train_steps(params, batches, cfg, opt, matmul)


def reference_late(cfg, traffic, seed, late: dict, device, opt, matmul="f32",
                   routes=None) -> dict:
    """The reference's readings of the late step, from the state the
    program's window left, on the step's own rows; with ``routes`` (one
    list a microbatch), on those expert picks.  The state is copied: the
    step updates its copy in place."""
    params, m, v = ({k: t.to(device, copy=True) for k, t in late["state"][name].items()}
                    for name in ("params", "m", "v"))
    batches = [base.make_batches(cfg, traffic, seed, late["step"], device)]
    return ref.train_steps(params, batches, cfg, opt, matmul, state=(m, v, late["count"]),
                           routes=[routes] if routes else None)


def compare(got: dict, want: dict) -> dict[str, float]:
    """``hetdp_train.compare``'s numbers, and ``grad_norm_gap_median``: the
    median leaf's gradient gap, as ``grad_norm_gap`` measures each leaf."""
    out = base.compare(got, want)
    gref = want["grad_norms"]
    gmed = float(np.median(list(gref.values())))
    out["grad_norm_gap_median"] = float(np.median(
        [abs(got["grad_norms"][k] - v) / max(v, gmed) for k, v in gref.items()]))
    return out
Cell = HetDPTrainHybrid
