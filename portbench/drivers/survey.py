"""Shot surveys scheduled by the port's A2WS pool: the paper's workload.

Set-up makes the velocity cube on the device from the seed (layers with
dipping interfaces between the configuration's two velocities), builds one
``repro_torch.seismic.tasks.make_shot_task`` for each distinct ``nt`` of
the traffic (each with a CUDA stream for each worker), and warms one shot of
each ``nt`` through them.  The window runs surveys back to back, each a
fresh ``A2WSRuntime`` over the survey's shots, until ``--seconds`` have
passed: no survey starts after that.  Every survey shoots and records along
a line of its own (a y drawn from the seed), so no two shots of a run are
the same.

The check waits for every shot of every survey, then recomputes a sample of
them with the plain reference (``portbench/reference/shot.py``) from the
same velocity cube.  The sample is drawn from the seed by strata, from the
pool's own records of who ran what: one stolen shot (run by another worker
than the one the static block partition gave it to), one shot of each
record length, and one shot of each worker, each stratum filled at most
once.  The number compared is the largest gap between a sampled seismogram
and the reference's, over the reference's peak.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import counts
from portbench.reference import shot as ref_shot
from repro_torch.core import A2WSRuntime, SlowdownEvent, SlowdownSchedule
from repro_torch.seismic import SeismicModel, Shot
from repro_torch.seismic.tasks import make_shot_task

SPAN_SURVEY = "pb.survey"
SPAN_SHOT = "pb.shot"


def velocity_cube(cfg: dict, seed: int, device) -> torch.Tensor:
    """(NZ, NY, NX) velocities in m/s, float32, on ``device``: ``interfaces``
    dipping planes, each a random depth, dip in x and y and a gentle fold,
    below which the velocity steps up; from ``vmin`` at the top to ``vmax``
    below the last."""
    nz, ny, nx = cfg["nz"], cfg["ny"], cfg["nx"]
    n_if = cfg["interfaces"]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((n_if, 5), generator=gen, device=device, dtype=torch.float64)
    y = torch.linspace(-1.0, 1.0, ny, device=device, dtype=torch.float64)[:, None]
    x = torch.linspace(-1.0, 1.0, nx, device=device, dtype=torch.float64)[None, :]
    z = torch.arange(nz, device=device, dtype=torch.float32)[:, None, None]
    vel = torch.full((nz, ny, nx), float(cfg["vmin_m_s"]), device=device)
    dv = (cfg["vmax_m_s"] - cfg["vmin_m_s"]) / n_if
    for i in range(n_if):
        base = (i + 0.5 + 0.8 * (u[i, 0] - 0.5)) * nz / (n_if + 1)
        depth = (base + 0.08 * nz * (u[i, 1] - 0.5) * x + 0.08 * nz * (u[i, 2] - 0.5) * y
                 + 0.03 * nz * torch.sin(3.0 * x + 6.28 * u[i, 3]) * torch.cos(2.0 * y + 6.28 * u[i, 4]))
        vel += dv * (z > depth.float()[None]).float()
    return vel


class Survey:
    """One run of a survey cell.  ``cfg`` is the configuration file's
    content, ``traffic`` the traffic file's, ``limits`` the cell's."""

    def __init__(self, cfg: dict, traffic: dict, limits: dict, seed: int, device):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.slowdowns = [float(s) for s in traffic["workers"]]
        self.rng = np.random.default_rng(seed)
        self.surveys: list[dict] = []  # one record per survey run in the window

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        cfg = self.cfg
        self.velocity = velocity_cube(cfg, self.seed, self.device)
        self.model = SeismicModel(
            velocity=self.velocity.to(getattr(torch, cfg["dtype"])), dx=cfg["dx_m"],
            dt=cfg["dt_s"], f_peak=cfg["f_peak_hz"], sponge=cfg["sponge"],
            sponge_decay=cfg["sponge_decay"])
        if not self.model.cfl_ok():
            raise RuntimeError("the configuration's dt breaks the port's CFL test")
        nz, ny, nx = self.velocity.shape
        d = cfg["source_depth"]
        self._rec_xs = range(0, nx, cfg["receiver_stride"])
        self.nts = sorted({int(g["nt"]) for g in self.traffic["shots"]})
        self.results: dict = {}
        self.task_fns = {nt: make_shot_task(self.model, nt, len(self.slowdowns), self.results)
                         for nt in self.nts}
        self.slowdown = SlowdownSchedule(
            [SlowdownEvent(w, 0.0, f) for w, f in enumerate(self.slowdowns) if f != 1.0])
        margin = cfg["sponge"] + 4
        self._xs = np.linspace(margin, nx - 1 - margin,
                               sum(int(g["count"]) for g in self.traffic["shots"])).astype(int)
        self._y_range = (margin, ny - 1 - margin)
        self._depth = d
        for nt in self.nts:  # one shot of each nt, through worker 0's stream
            warm = Shot(src=(d, ny // 2, nx // 2), receivers=self._receivers(ny // 2))
            self.task_fns[nt](0, warm)
        self.results.clear()

    def _receivers(self, y: int) -> tuple:
        return tuple((self.cfg["receiver_depth"], y, int(x)) for x in self._rec_xs)

    def _survey_tasks(self) -> list:
        """The next survey: the traffic's shots in order along x on a line of
        its own (a y drawn from the seed), recorded by receivers along the
        same line; each task ``(shot, nt)``."""
        y = int(self.rng.integers(*self._y_range, endpoint=True))
        nts = [int(g["nt"]) for g in self.traffic["shots"] for _ in range(int(g["count"]))]
        rec = self._receivers(y)
        return [(Shot(src=(self._depth, y, int(x)), receivers=rec), nt)
                for x, nt in zip(self._xs, nts)]

    # ------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        light = min(self.nts)
        classes = dict(cost_class_fn=lambda t: int(t[1] > light), num_classes=2) \
            if self.traffic.get("cost_classes") else {}

        def task_fn(wid: int, task) -> None:
            with record_function(SPAN_SHOT):
                self.task_fns[task[1]](wid, task[0])

        t_start = time.perf_counter()
        while True:  # at least one survey; none starts after ``seconds``
            tasks = self._survey_tasks()
            pool_seed = int(self.rng.integers(2**31))
            with record_function(SPAN_SURVEY):
                t0 = time.perf_counter()
                rt = A2WSRuntime(tasks, len(self.slowdowns), task_fn, seed=pool_seed,
                                 policy=self.traffic["policy"], slowdown=self.slowdown, **classes)
                stats = rt.run()
                t_end = time.perf_counter()
            self.surveys.append({"tasks": tasks, "stats": stats, "start": t0, "end": t_end,
                                 "results": dict(self.results)})
            self.results.clear()
            if t_end - t_start >= seconds:
                return {"survey_makespan_s": (t_end - t_start) / len(self.surveys)}

    def counters(self) -> dict:
        cells = int(np.prod(self.velocity.shape))
        steps = sum(nt for s in self.surveys for _, nt in s["tasks"])
        return {"surveys": self.surveys, "cells": cells, "shot_steps": steps, "counts": counts}

    def detail(self) -> dict:
        """Per-survey readings of the window, for reading a run's spread."""
        return {"makespan_s": [s["end"] - s["start"] for s in self.surveys],
                "steals": [len(s["stats"].steals) for s in self.surveys],
                "tasks_per_worker": [s["stats"].per_worker_tasks for s in self.surveys],
                "checked": self.checked}

    def release(self) -> None:
        del self.task_fns, self.model
        self.results = {}

    # -------------------------------------------------------------- check
    def check(self) -> tuple[int, int, dict]:
        """(shots attempted, shots without a sound answer, {number: (value,
        limit)}).  A shot that raised, or whose seismogram is missing, of the
        wrong shape or not finite, counts as failed."""
        n_rec, workers = len(self._rec_xs), len(self.slowdowns)
        attempted = failed = 0
        done = []  # (shot, nt, seismogram, worker, stolen)
        for s in self.surveys:
            ran = {r.task[0].src: r.worker for r in s["stats"].records}
            for (shot, nt), owner in zip(s["tasks"], block_owners(len(s["tasks"]), workers)):
                attempted += 1
                seis = s["results"].get(shot.src)
                if seis is None or seis.shape != (nt, n_rec) or not np.isfinite(seis).all():
                    failed += 1
                else:
                    w = ran.get(shot.src)
                    done.append((shot, nt, seis, w, w is not None and w != owner))
        strata = [lambda d: d[4]]
        strata += [lambda d, nt=nt: d[1] == nt for nt in self.nts]
        strata += [lambda d, w=w: d[3] == w for w in range(workers)]
        order = [done[int(i)] for i in self.rng.permutation(len(done))]
        sample = []
        for stratum in strata:
            if not any(stratum(d) for d in sample):
                sample += [d for d in order if stratum(d)][:1]
        self.sample = [d[:3] for d in sample]
        self.checked = [{"worker": d[3], "stolen": d[4], "nt": d[1]} for d in sample]
        self.want = [self.reference(shot, nt) for shot, nt, _ in self.sample]
        worst = max((seis_gap(seis, want) for (_, _, seis), want in zip(self.sample, self.want)),
                    default=0.0)
        return attempted, failed, {"seis_gap": (worst, float(self.limits["seis_gap"]))}

    def reference(self, shot, nt: int, dtype=torch.float32) -> np.ndarray:
        """The plain reference's seismogram of ``shot`` from the run's cube."""
        cfg = self.cfg
        return ref_shot.shot(self.velocity, shot.src, list(shot.receivers), nt, dx=cfg["dx_m"],
                             dt=cfg["dt_s"], f_peak=cfg["f_peak_hz"], width=cfg["sponge"],
                             decay=cfg["sponge_decay"], dtype=dtype).float().cpu().numpy()


def block_owners(n: int, workers: int) -> list[int]:
    """Each of ``n`` tasks' worker under the static block partition that the
    pool starts from (the paper's section 2.2.1): contiguous blocks in task
    order, the first ``n % workers`` one task longer."""
    base, rem = divmod(n, workers)
    return [w for w in range(workers) for _ in range(base + (w < rem))]


def seis_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest gap between two seismograms over the reference's peak."""
    peak = float(np.abs(want).max())
    return float(np.abs(got.astype(np.float64) - want).max()) / peak if peak > 0 else np.inf


Cell = Survey
