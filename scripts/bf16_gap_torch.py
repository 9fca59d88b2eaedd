#!/usr/bin/env python3
"""The bf16 gap between prefill and token-by-token decode, in the JAX
reference and in the PyTorch port, on the same weights and prompts, on the
CPU.

For each depth the config is cut to that many layers (full width otherwise),
the reference's ``lm.init(key 0)`` draws the weights, and the port gets the
same weights through ``repro_torch.models.bridge``.  Each of ``--prompts``
random prompts of ``--prompt-len`` tokens runs through ``lm.prefill`` and
through ``--prompt-len`` calls of ``lm.decode_step``, in bf16; the last
logits of the two are compared over the real vocabulary (the first
``cfg.vocab`` columns; the padded ones are masked to -2e38).  Per depth and
framework it prints max|d| and the relative L2 gap ``|pre - dec| / |dec|``,
each the largest over the prompts, and how many prompts' argmax differ.
These are the numbers behind the bf16 bounds of ``chip_smoke.py``'s
recurrent phases.

    PYTHONPATH=src python scripts/bf16_gap_torch.py --arch mamba2-2.7b \
        --layers 4 8 16 --prompts 4

``--generate N`` also prints each framework's greedy completion of N new
tokens for the first 16 tokens of every prompt (``launch.serve.generate``
of each package).  ``--smoke`` runs the SMOKE config instead (seconds; for
a quick check).

This script is the one place outside the tests where the port meets the
reference: it imports both.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.checkpoint.store import _flatten
from repro.launch import serve as jlaunch
from repro.models import lm as jlm
import repro_torch.configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.bridge import params_from_flat


def gap(pre: np.ndarray, dec: np.ndarray, vocab: int) -> dict:
    """pre, dec [B, V] f32: max|d|, relative L2 and argmax agreement over
    the real vocabulary, each the worst over the rows."""
    pre, dec = pre[:, :vocab].astype(np.float64), dec[:, :vocab].astype(np.float64)
    d = pre - dec
    rel = np.linalg.norm(d, axis=-1) / np.linalg.norm(dec, axis=-1)
    flips = int((pre.argmax(-1) != dec.argmax(-1)).sum())
    return {"max_abs": float(np.abs(d).max()), "rel_l2": float(rel.max()),
            "rel_l2_mean": float(rel.mean()), "argmax_flips": flips,
            "max_abs_logit": float(np.abs(dec).max())}


def reference_gap(jcfg, jp, toks: np.ndarray) -> dict:
    b, s = toks.shape
    pre, _ = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t}, jcfg))(jp, jnp.asarray(toks))
    step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg), donate_argnums=2)
    caches = jlm.init_caches(jcfg, b, s)
    for i in range(s):
        logits, caches = step(jp, jnp.asarray(toks[:, i : i + 1]), caches, jnp.int32(i))
    return gap(np.asarray(pre[:, -1]), np.asarray(logits[:, -1]), jcfg.vocab)


@torch.inference_mode()
def port_gap(tcfg, tp, toks: np.ndarray) -> dict:
    b, s = toks.shape
    t = torch.from_numpy(toks).long()
    pre, _ = tlm.prefill(tp, {"tokens": t}, tcfg)
    caches = tlm.init_caches(tcfg, b, s, device="cpu")
    for i in range(s):
        logits, caches = tlm.decode_step(tp, t[:, i : i + 1], caches, i, tcfg)
    return gap(pre[:, -1].numpy(), logits[:, -1].numpy(), tcfg.vocab)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0, help="numpy seed of the prompts")
    ap.add_argument("--generate", type=int, default=0,
                    help="also print greedy completions of this many tokens")
    ap.add_argument("--smoke", action="store_true", help="the SMOKE config, not full width")
    args = ap.parse_args(argv)

    get = "get_smoke" if args.smoke else "get_config"
    for layers in args.layers:
        jcfg = getattr(jconfigs, get)(args.arch).with_(n_layers=layers, dtype="bfloat16")
        tcfg = getattr(tconfigs, get)(args.arch).with_(n_layers=layers, dtype="bfloat16")
        toks = np.random.default_rng(args.seed).integers(
            0, jcfg.vocab, (args.prompts, args.prompt_len)).astype(np.int32)
        t0 = time.perf_counter()
        jp, _ = jlm.init(jcfg, jax.random.key(0))
        ref = reference_gap(jcfg, jp, toks)
        if args.generate:
            ref["completions"] = np.asarray(
                jlaunch.generate(jcfg, jp, jnp.asarray(toks[:, :16]), args.generate)).tolist()
        t1 = time.perf_counter()
        flat = _flatten(jp)
        del jp
        tp = params_from_flat(flat, device="cpu", dtype=torch.bfloat16)
        del flat
        port = port_gap(tcfg, tp, toks)
        if args.generate:
            with torch.inference_mode():
                port["completions"] = tlaunch.generate(
                    tcfg, tp, torch.from_numpy(toks[:, :16]).long(), args.generate).tolist()
        del tp
        t2 = time.perf_counter()
        row = {"arch": args.arch, "layers": layers, "d_model": tcfg.d_model,
               "prompts": args.prompts, "prompt_len": args.prompt_len,
               "reference": ref, "port": port,
               "rel_l2_ratio": port["rel_l2"] / ref["rel_l2"],
               "seconds": {"reference": round(t1 - t0, 1), "port": round(t2 - t1, 1)}}
        print(f"{args.arch} {layers} layers, {args.prompts} prompts of {args.prompt_len}: "
              f"reference max|d| {ref['max_abs']:.4f} rel L2 {ref['rel_l2']:.3e} "
              f"(mean {ref['rel_l2_mean']:.3e}) argmax flips {ref['argmax_flips']}; "
              f"port max|d| {port['max_abs']:.4f} rel L2 {port['rel_l2']:.3e} "
              f"(mean {port['rel_l2_mean']:.3e}) argmax flips {port['argmax_flips']}; "
              f"ratio {row['rel_l2_ratio']:.3f}; {row['seconds']}", flush=True)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
