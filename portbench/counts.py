"""Operations and bytes of the port's work, computed from shapes, and the
published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).

The shot counts are those of ``chip_smoke.py``'s phase 4 (K1) and the
training counts those of its phase 18, copied here so that the benchmark
keeps its own yardstick.
"""

from __future__ import annotations

H100_FP32_FLOP_PER_S = 67e12
H100_BF16_FLOP_PER_S = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# K1, one leapfrog step of the 25-tap radius-4 star: 13 multiplies and 24
# adds for the taps, the divide by dx^2, and the leapfrog's 4 operations.
K1_FLOP_PER_CELL = 42
# u, u_prev and c2dt2 read once, u_next written once, fp32.
K1_BYTES_PER_CELL = 16
# The whole shot step (K1 and run_shot's epilogue): K1's operations and the
# two mask multiplies; K1's bytes and the mask read once.  The source add and
# the receiver gather touch one cell and the receivers, and are left out.
STEP_FLOP_PER_CELL = K1_FLOP_PER_CELL + 2
STEP_BYTES_PER_CELL = K1_BYTES_PER_CELL + 4


def least_s(flops: float, nbytes: float, flop_per_s: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / flop_per_s, nbytes / H100_HBM_BYTES_PER_S)


def k1_least_s(cells: int) -> float:
    """K1's least time for one launch over ``cells`` fp32 cells (bytes-bound
    at every size: 16 B against 42 flops a cell)."""
    return least_s(K1_FLOP_PER_CELL * cells, K1_BYTES_PER_CELL * cells, H100_FP32_FLOP_PER_S)


def k1_bytes(cells: int) -> int:
    return K1_BYTES_PER_CELL * cells


def shot_step_least_s(cells: int) -> float:
    """The least time of one whole shot step (K1 with its epilogue)."""
    return least_s(STEP_FLOP_PER_CELL * cells, STEP_BYTES_PER_CELL * cells,
                   H100_FP32_FLOP_PER_S)


def lm_matmul_params(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                     d_ff: int, vocab: int, n_layers: int) -> int:
    """Parameters that take part in a matrix product: each layer's q, k, v
    and o projections and its gated MLP, and the output head.  The
    embedding is a lookup and the norms scale; neither is counted."""
    attn = d_model * (n_heads + 2 * n_kv_heads) * head_dim + n_heads * head_dim * d_model
    mlp = 3 * d_model * d_ff
    return n_layers * (attn + mlp) + d_model * vocab


def causal_attention_flops(rows: int, seq: int, n_heads: int, head_dim: int,
                           n_layers: int) -> int:
    """Forward flops of causal attention's two products (scores and values)
    over the keys each query sees: 2 products x 2 flops x head_dim for each
    of rows * seq(seq+1)/2 query-key pairs, per head and layer."""
    keys = rows * seq * (seq + 1) // 2
    return 4 * keys * n_heads * head_dim * n_layers


def train_step_flops(matmul_params: int, tokens: int, attn_forward: int) -> int:
    """A training step's model flops: forward and backward (3 x forward) of
    the products, 6 x parameters x tokens, and 3 x attention's forward.
    Rematerialisation's recompute is not counted."""
    return 6 * matmul_params * tokens + 3 * attn_forward


def paced_floor_s(mb_s: float, tasks: int, slowdowns: list[float], pace: float) -> float:
    """The least makespan of a step's ``tasks`` paced microbatch tasks (a copy
    of ``chip_smoke.py::paced_floor_ms``): a task costs its microbatch
    ``mb_s`` plus a sleep of ``pace`` microbatches times its worker's
    slowdown.  (a) Balanced over the workers as if tasks could be split:
    tasks / sum(1 / (1 + pace * slowdown)) microbatches; (b) one card runs
    the microbatches one after another and the last one still sleeps:
    tasks + pace * min(slowdown).  The floor is the larger."""
    balanced = tasks / sum(1.0 / (1.0 + pace * max(s, 1.0)) for s in slowdowns)
    serial = tasks + pace * max(min(slowdowns), 1.0)
    return max(balanced, serial) * mb_s
