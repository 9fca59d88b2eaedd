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

An enc-dec or VLM arch (seamless-m4t-medium, qwen2-vl-2b) runs the check of
``chip_smoke.py``'s phases 15-16 instead, whose decode starts from a
prefill: the prompt (seamless: 1500 stub frames at std 0.2 and the first
112 of 128 tokens; qwen2-vl: a 16x16 grid of stub patch embeddings at std
0.2 on M-RoPE positions (0, i, j), then 64 text tokens at t = h = w =
16 + k) through ``lm.prefill`` and ``pad_caches``, then a decode step for
each of 16 continuation tokens, each step's logits against ``lm.forward``
over the prompt and the continuation at that position (the gap printed
first, every row of every prompt), and the last step's against
``lm.prefill`` of the whole (second).  ``--layers`` cuts the decoder;
``max_below`` is the worst of how far below forward's top logit the
decode's top token lies there, where the two argmax differ.

    PYTHONPATH=src python scripts/bf16_gap_torch.py --arch seamless-m4t-medium \
        --layers 12 --prompts 4

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
    the real vocabulary, each the worst over the rows; ``max_below`` is how
    far below ``dec``'s top ``pre``'s top token lies, the worst row, and
    ``strict_flips`` the rows where it lies below (``argmax_flips`` also
    counts exact ties); ``near_ties`` the rows whose top two logits in
    ``dec`` are no further apart than that row's max|d|, which a gap of that
    size may reorder."""
    pre, dec = pre[:, :vocab].astype(np.float64), dec[:, :vocab].astype(np.float64)
    d = pre - dec
    rel = np.linalg.norm(d, axis=-1) / np.linalg.norm(dec, axis=-1)
    flips = int((pre.argmax(-1) != dec.argmax(-1)).sum())
    below = dec.max(-1) - dec[np.arange(len(dec)), pre.argmax(-1)]
    top2 = np.sort(dec, -1)[:, -2:]
    near = int((top2[:, 1] - top2[:, 0] <= np.abs(d).max(-1)).sum())
    return {"max_abs": float(np.abs(d).max()), "rel_l2": float(rel.max()),
            "rel_l2_mean": float(rel.mean()), "argmax_flips": flips, "rows": len(dec),
            "strict_flips": int((below > 0).sum()), "max_below": float(below.max()),
            "near_ties": near, "max_abs_logit": float(np.abs(dec).max())}


CONTINUE = 16  # decode steps after the prefill (chip_smoke.py's CONTINUE)


def continue_inputs(cfg, embed: np.ndarray, prompts: int, seed: int):
    """(prompt, full, cont, p0) as numpy batches for an enc-dec or VLM
    config: chip_smoke.py's phase 15-16 requests, drawn from numpy.
    ``embed`` is the token embedding table (f32; the VLM's text rows)."""
    r = np.random.default_rng(seed)
    d = cfg.d_model
    if cfg.enc_layers:
        enc = (r.standard_normal((prompts, 1500, d)) * 0.2).astype(np.float32)
        toks = r.integers(0, cfg.vocab, (prompts, 128)).astype(np.int32)
        p0 = 128 - CONTINUE
        return ({"tokens": toks[:, :p0], "enc_embeds": enc}, {"tokens": toks, "enc_embeds": enc},
                toks[:, p0:], p0)
    grid, n_text = 16, 64
    patches = (r.standard_normal((prompts, grid * grid, d)) * 0.2).astype(np.float32)
    text = r.integers(0, cfg.vocab, (prompts, n_text))
    cont = r.integers(0, cfg.vocab, (prompts, CONTINUE)).astype(np.int32)
    i, j = np.divmod(np.arange(grid * grid), grid)
    p0 = grid * grid + n_text
    pos = np.concatenate([np.stack([np.zeros_like(i), i, j]),
                          np.broadcast_to(grid + np.arange(n_text), (3, n_text)),
                          np.broadcast_to(p0 + np.arange(CONTINUE), (3, CONTINUE))], 1)
    pos = np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, prompts, p0 + CONTINUE)))
    emb = np.concatenate([patches, embed[text], embed[cont]], 1).astype(np.float32)
    return ({"embeds": emb[:, :p0], "positions": pos[..., :p0]},
            {"embeds": emb, "positions": pos}, cont, p0)


def reference_continue(jcfg, jp, prompt, full, cont, p0) -> tuple[dict, dict]:
    j = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    fwd, _ = jax.jit(lambda p, b: jlm.forward(p, b, jcfg))(jp, j(full))
    pre = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg))
    last, _ = pre(jp, j(full))
    _, caches = pre(jp, j(prompt))
    caches = jlm.pad_caches(caches, jcfg, p0 + cont.shape[1])
    step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg), donate_argnums=2)
    outs = []
    for i in range(cont.shape[1]):
        logits, caches = step(jp, jnp.asarray(cont[:, i : i + 1]), caches, jnp.int32(p0 + i))
        outs.append(np.asarray(logits[:, -1]))
    dec, want, v = np.stack(outs, 1), np.asarray(fwd[:, p0:]), jcfg.vocab
    return (gap(dec.reshape(-1, dec.shape[-1]), want.reshape(-1, want.shape[-1]), v),
            gap(dec[:, -1], np.asarray(last[:, -1]), v))


@torch.inference_mode()
def port_continue(tcfg, tp, prompt, full, cont, p0) -> tuple[dict, dict]:
    t = lambda b: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}  # noqa: E731
    fwd, _ = tlm.forward(tp, t(full), tcfg)
    last, _ = tlm.prefill(tp, t(full), tcfg)
    _, caches = tlm.prefill(tp, t(prompt), tcfg)
    caches = tlm.pad_caches(caches, tcfg, p0 + cont.shape[1])
    c = torch.from_numpy(cont).long()
    dec = torch.cat([tlm.decode_step(tp, c[:, i : i + 1], caches, p0 + i, tcfg)[0]
                     for i in range(cont.shape[1])], 1).numpy()
    v = tcfg.vocab
    return (gap(dec.reshape(-1, dec.shape[-1]), fwd[:, p0:].reshape(-1, fwd.shape[-1]).numpy(), v),
            gap(dec[:, -1], last[:, -1].numpy(), v))


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
        if jcfg.enc_layers or jcfg.frontend != "none":
            continue_main(args, layers, jcfg, tcfg, jp, t0)
            continue
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


def continue_main(args, layers, jcfg, tcfg, jp, t0) -> None:
    """The enc-dec / VLM form of one depth's row: decode after a prefill
    against forward, and the last step against prefill of the whole."""
    embed = np.asarray(jp["embed"], np.float32)
    inputs = continue_inputs(tcfg, embed, args.prompts, args.seed)
    ref = reference_continue(jcfg, jp, *inputs)
    t1 = time.perf_counter()
    flat = _flatten(jp)
    del jp
    tp = params_from_flat(flat, device="cpu", dtype=torch.bfloat16)
    del flat
    port = port_continue(tcfg, tp, *inputs)
    del tp
    t2 = time.perf_counter()
    for what, r, p in (("decode vs forward", ref[0], port[0]),
                       ("last decode vs prefill of all", ref[1], port[1])):
        row = {"arch": args.arch, "layers": layers, "d_model": tcfg.d_model, "check": what,
               "prompts": args.prompts, "reference": r, "port": p,
               "rel_l2_ratio": p["rel_l2"] / r["rel_l2"],
               "seconds": {"reference": round(t1 - t0, 1), "port": round(t2 - t1, 1)}}
        print(f"{args.arch} {layers} layers, {args.prompts} prompts, {what}: " + "; ".join(
            f"{name} max|d| {g['max_abs']:.4f} rel L2 {g['rel_l2']:.3e} (mean "
            f"{g['rel_l2_mean']:.3e}) argmax differs in {g['argmax_flips']} of {g['rows']} rows, "
            f"{g['strict_flips']} below the top (worst {g['max_below']:.4f}), near ties "
            f"{g['near_ties']}" for name, g in (("reference", r), ("port", p)))
            + f"; ratio {row['rel_l2_ratio']:.3f}; {row['seconds']}", flush=True)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
