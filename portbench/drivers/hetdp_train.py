"""Heterogeneous data-parallel training through the port's
``repro_torch.runtime.het_dp.HetDPTrainer``: A2WS over microbatch tasks.

Set-up draws the weights on the device from the seed, one generator a leaf,
in the stored dtype (bfloat16), builds the ``repro_torch`` model
configuration from the configuration file, times one microbatch's gradient
(the trainer's pacing, as ``chip_smoke.py``'s phase 18 does: the median of
five calls), builds one trainer, and drives it through its first
``check_steps`` steps with the window's own call (``trainer.step``) on
microbatches drawn from the seed.  It keeps what the check compares: each
step's loss, the first step's gradient norm of each leaf as the optimizer
got it (from its first moment and the clip scale), and each leaf's change
over those steps.  The window hands the same trainer more steps, each on
fresh rows, until ``--seconds`` have passed.

Once the window has closed, the same trainer takes one more step through
the same call (the late step), from the state the window left: its
parameters and moments are copied to the host first, so that the reference
can follow that step from them, and the step's gradient (from the change of
the first moment) and change of each leaf are kept.  A change that acts
only from some step on acts on it too.

The check, once the trainer is freed, follows the first steps from the same
weights and rows with the plain reference (``portbench/reference/lm.py``)
in float32, and the late step from the copied state, and compares the
numbers by the worst leaf.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import counts
from portbench.reference import lm as ref_lm
from repro_torch.autodiff import value_and_grad
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec

SPAN_STEP = "pb.train.step"
_MIX = 0x9E3779B97F4A7C15


def _seed(seed: int, i: int) -> int:
    """A 63-bit generator seed for stream ``i`` of run ``seed``."""
    return (seed * _MIX + i * 0xBF58476D1CE4E5B9 + 1) % (2**63)


def leaf_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], float | None]]:
    """Each leaf's shape and the std it is drawn with (None: zeros), by its
    path in the stacked tree both the port and the reference read."""
    d, ff, v, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    h, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    g = "groups/0/b0/"
    head = {} if cfg["tie_word_embeddings"] else {"head": ((d, v), 0.02)}
    return {
        "embed": ((v, d), 0.02), **head, "final_norm": ((d,), None),
        g + "norm1": ((n, d), None), g + "norm2": ((n, d), None),
        g + "attn/wq": ((n, d, h * hd), d ** -0.5), g + "attn/wk": ((n, d, hkv * hd), d ** -0.5),
        g + "attn/wv": ((n, d, hkv * hd), d ** -0.5), g + "attn/wo": ((n, h * hd, d), (h * hd) ** -0.5),
        g + "mlp/w_gate": ((n, d, ff), d ** -0.5), g + "mlp/w_up": ((n, d, ff), d ** -0.5),
        g + "mlp/w_down": ((n, ff, d), ff ** -0.5),
    }


def make_leaf(cfg: dict, seed: int, path: str, device, dtype) -> torch.Tensor:
    """One leaf, drawn on ``device`` from its own generator (so that any
    leaf can be drawn again alone), normal in float32, stored in ``dtype``."""
    shapes = leaf_shapes(cfg)
    shape, std = shapes[path]
    if std is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, sorted(shapes).index(path)))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(std).to(dtype)


def make_params(cfg: dict, seed: int, device, dtype) -> dict:
    """The weights as a tree: ``embed``, ``head`` (untied only),
    ``final_norm`` and ``groups[0]["b0"]`` with the stacked layer leaves."""
    tree: dict = {"groups": [{"b0": {"attn": {}, "mlp": {}}}]}
    for path in leaf_shapes(cfg):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node[int(p)] if p.isdigit() else node[p]
        node[parts[-1]] = make_leaf(cfg, seed, path, device, dtype)
    return tree


def make_batches(cfg: dict, traffic: dict, seed: int, step: int, device) -> list[dict]:
    """Step ``step``'s microbatches: ``tasks`` of ``rows`` x ``seq`` token ids
    drawn uniformly from the vocabulary, each row its own, labels the next
    token."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 1_000_000 + step))
    t = torch.randint(0, cfg["vocab_size"], (traffic["tasks"], traffic["rows"], traffic["seq"] + 1),
                      generator=gen, device=device)
    return [{"tokens": r[:, :-1], "labels": r[:, 1:]} for r in t]


def port_config(cfg: dict):
    """The ``repro_torch`` model configuration the file describes."""
    return ModelConfig(
        name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"], norm_eps=cfg["rms_norm_eps"],
        max_seq=cfg["max_position_embeddings"], dtype=cfg["torch_dtype"], remat=cfg["remat"],
        act=cfg["hidden_act"])


def _leaf_norms(tree) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in ref_lm.flat_leaves(tree).items()}


class HetDPTrain:
    """One run of a training cell."""

    def __init__(self, cfg: dict, traffic: dict, limits: dict, seed: int, device):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.dtype = getattr(torch, cfg["torch_dtype"])
        self.slowdowns = [float(s) for s in traffic["workers"]]
        self.history: list[dict] = []  # the window's steps
        self.step_walls: list[float] = []

    def _opt(self) -> dict:
        t = self.traffic
        return dict(lr=t["lr"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                    weight_decay=t["weight_decay"], clip_norm=t["clip_norm"])

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        pcfg = port_config(cfg)
        self.pcfg = pcfg
        params = make_params(cfg, self.seed, dev, self.dtype)
        loss_fn = lambda p, b: lm.loss_fn(p, b, pcfg)  # noqa: E731
        # the pacing: one microbatch's gradient alone, as phase 18 times it
        grad = value_and_grad(loss_fn)
        mb = make_batches(cfg, self.traffic, self.seed, -1, dev)[0]
        times = []
        for _ in range(6):  # the first call warms; the median of the rest
            self._sync()
            t0 = time.perf_counter()
            grad(params, mb)
            self._sync()
            times.append(time.perf_counter() - t0)
        self.mb_s = float(np.median(times[1:]))
        workers = [WorkerSpec(f"w{i}", slow_factor=f) for i, f in enumerate(self.slowdowns)]
        self.trainer = HetDPTrainer(loss_fn, params, workers, AdamWConfig(**self._opt()),
                                    base_task_time=self.traffic["pace"] * self.mb_s)
        del params
        n = self.limits["check_steps"]
        self.prog = {"losses": []}
        b1 = self.traffic["b1"]
        for step in range(n):
            m = self.trainer.step(make_batches(cfg, self.traffic, self.seed, step, dev))
            self.prog["losses"].append(m["loss"])
            if step == 0:  # the gradient as the optimizer got it, before its clip
                scale = min(1.0, self.traffic["clip_norm"] / max(m["grad_norm"], 1e-9))
                self.prog["grad_norms"] = {k: v / ((1.0 - b1) * scale) for k, v in
                                           _leaf_norms(self.trainer.opt_state["m"]).items()}
        change = {}
        for k, p in ref_lm.flat_leaves(self.trainer.params).items():
            p0 = make_leaf(cfg, self.seed, k, dev, self.dtype)
            change[k] = float((p.double() - p0.double()).norm())
            del p0
        self.prog["change_norms"] = change
        self._sync()

    def _alloc_retries(self) -> int:
        """The caching allocator's retries so far (each frees its cache and
        allocates again); 0 off the card."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.memory_stats(self.device).get("num_alloc_retries", 0))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        step = self.limits["check_steps"]
        self._sync()
        self.retries = [self._alloc_retries()]
        t_start = time.perf_counter()
        while True:  # at least one step; none starts after ``seconds``
            mbs = make_batches(self.cfg, self.traffic, self.seed, step, self.device)
            with record_function(SPAN_STEP):
                t0 = time.perf_counter()
                m = self.trainer.step(mbs)
                self._sync()
                t_end = time.perf_counter()
            self.history.append(m)
            self.step_walls.append(t_end - t0)
            self.retries.append(self._alloc_retries())
            step += 1
            if t_end - t_start >= seconds:
                return {"train_step_s": (t_end - t_start) / len(self.history)}

    def counters(self) -> dict:
        c = self.cfg
        tokens = self.traffic["tasks"] * self.traffic["rows"] * self.traffic["seq"]
        mm = counts.lm_matmul_params(c["hidden_size"], c["num_attention_heads"],
                                     c["num_key_value_heads"], c["head_dim"],
                                     c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"])
        attn = counts.causal_attention_flops(
            self.traffic["tasks"] * self.traffic["rows"], self.traffic["seq"],
            c["num_attention_heads"], c["head_dim"], c["num_hidden_layers"])
        stats = self.trainer.history[-len(self.history):] if self.history else []
        return {"pool_stats": stats, "microbatch_s": self.mb_s,
                "tasks": self.traffic["tasks"], "slowdowns": self.slowdowns,
                "pace": self.traffic["pace"],
                "step_flops": counts.train_step_flops(mm, tokens, attn), "counts": counts}

    def release(self) -> None:
        """Take the late step, then free the trainer."""
        self._late_step()
        self.trainer = None

    def _late_step(self) -> None:
        """One more ``trainer.step`` from the window's state, on rows of its
        own; keeps the state it started from (on the host), the step's loss,
        each leaf's gradient norm as the optimizer got it (the first
        moment's change over its share, before the clip) and each leaf's
        change."""
        tr, dev, b1 = self.trainer, self.device, self.traffic["b1"]
        state = {name: {k: v.detach().to("cpu", copy=True) for k, v in ref_lm.flat_leaves(t).items()}
                 for name, t in (("params", tr.params), ("m", tr.opt_state["m"]),
                                 ("v", tr.opt_state["v"]))}
        count = int(tr.opt_state["count"])
        step = self.limits["check_steps"] + len(self.history)
        m = tr.step(make_batches(self.cfg, self.traffic, self.seed, step, dev))
        scale = min(1.0, self.traffic["clip_norm"] / max(m["grad_norm"], 1e-9))
        grads, change = {}, {}
        m_new = ref_lm.flat_leaves(tr.opt_state["m"])
        for k, p in ref_lm.flat_leaves(tr.params).items():
            g = m_new[k].float() - b1 * state["m"][k].to(dev).float()
            grads[k] = float(g.double().norm()) / ((1.0 - b1) * scale)
            change[k] = float((p.double() - state["params"][k].to(dev).double()).norm())
            del g
        self.late = {"step": step, "count": count, "state": state, "losses": [m["loss"]],
                     "grad_norms": grads, "change_norms": change}
        self._sync()

    def detail(self) -> dict:
        """Per-step readings of the window, for reading a run's spread."""
        h = self.history
        return {"microbatch_s": self.mb_s, "step_s": self.step_walls,
                "makespan_s": [m["makespan"] for m in h], "steals": [m["steals"] for m in h],
                "tasks_per_worker": [m["tasks_per_worker"] for m in h],
                "alloc_retries": [b - a for a, b in zip(self.retries, self.retries[1:])],
                "losses": self.prog["losses"], "late_step": self.late["step"],
                "worst_grad_leaves": {"first": worst_leaves(self.prog, self.want),
                                      "late": worst_leaves(self.late, self.late_want)},
                "not_compared": self.not_compared}

    # -------------------------------------------------------------- check
    def check(self) -> tuple[int, int, dict]:
        """(steps attempted, steps failed, {number: (value, limit)}): the
        window's steps; the first ``check_steps`` and the late step against
        the reference (the late step's numbers named ``late_*``)."""
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
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        self.want, self.late_want = want, late_want
        gaps = compare(self.prog, want)
        gaps.update({"late_" + k: v for k, v in compare(self.late, late_want).items()})
        # a number without a limit separates no control or fault from sound
        # runs (PERF.md gives its readings): reported, not compared
        self.not_compared = {k: v for k, v in gaps.items() if k not in self.limits}
        return attempted, failed, {k: (v, float(self.limits[k])) for k, v in gaps.items()
                                   if k in self.limits}


def reference_readings(cfg, traffic, seed, steps, device, dtype, opt, matmul="f32") -> dict:
    """The reference's readings of the first ``steps`` steps from the run's
    weights and rows."""
    params = ref_lm.flat_leaves(make_params(cfg, seed, device, dtype))
    batches = [make_batches(cfg, traffic, seed, s, device) for s in range(steps)]
    return ref_lm.train_steps(params, batches, cfg, opt, matmul)


def reference_late(cfg, traffic, seed, late: dict, device, opt, matmul="f32") -> dict:
    """The reference's readings of the late step, followed from the state the
    program's window left (its parameters and moments, copied before the
    step) on the step's own rows."""
    params, m, v = ({k: t.to(device) for k, t in late["state"][name].items()}
                    for name in ("params", "m", "v"))
    batches = [make_batches(cfg, traffic, seed, late["step"], device)]
    return ref_lm.train_steps(params, batches, cfg, opt, matmul, state=(m, v, late["count"]))


def worst_leaves(got: dict, want: dict, n: int = 3) -> list:
    """The ``n`` leaves whose gradient norms lie farthest apart, as
    ``grad_norm_gap`` measures each: [[leaf, gap, its norm over the
    median leaf's], ...]."""
    gref = want["grad_norms"]
    gmed = float(np.median(list(gref.values())))
    gaps = [[k, abs(got["grad_norms"][k] - v) / max(v, gmed), v / gmed] for k, v in gref.items()]
    return sorted(gaps, key=lambda g: -g[1])[:n]


def compare(got: dict, want: dict) -> dict[str, float]:
    """The three numbers: the largest relative gap of a step's loss; and, by
    the worst leaf, the gap between the two sides' norms of the first
    gradient and of the change over the steps, each over the larger of that
    leaf's reference norm and the median leaf's.  A leaf whose reference
    gradient is under a thousandth of the median leaf's moves by round-off
    alone and is left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    gref = want["grad_norms"]
    gmed = float(np.median(list(gref.values())))
    grad = max(abs(got["grad_norms"][k] - v) / max(v, gmed) for k, v in gref.items())
    moving = [k for k, v in gref.items() if v >= 1e-3 * gmed]
    cref = want["change_norms"]
    cmed = float(np.median([cref[k] for k in moving]))
    change = max(abs(got["change_norms"][k] - cref[k]) / max(cref[k], cmed) for k in moving)
    return {"loss_gap": loss, "grad_norm_gap": grad, "change_norm_gap": change}


Cell = HetDPTrain
