"""Model flops of a Granite-4.0-H training step (Mamba-2 and attention
layers, each with a routed MoE beside a shared expert), computed from the
configuration file's shapes and the rows the held experts computed.

Counted: the weight products, forward and backward (6 x parameters x
rows), the routed experts at the rows they computed (``moe.rows_held``,
which the program counts), attention's two causal products and the SSD's
products within and across chunks, each 3 x its forward.  Not counted:
rematerialisation's recompute, the conv, norms and elementwise work.
"""

from __future__ import annotations

from portbench import counts


def dense_matmul_params(cfg: dict) -> int:
    """Parameters every token meets in a weight product: each Mamba-2
    layer's input and output projections, each attention layer's q, k, v
    and o, every layer's router and shared expert, and the tied head."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hd, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    g = cfg["mamba_n_groups"]
    d_in = h * hd
    mamba = d * (2 * d_in + 2 * g * n + h) + d_in * d
    ah, akv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ahd = d // ah
    attn = d * (ah + 2 * akv) * ahd + ah * ahd * d
    ffn = d * cfg["router_experts"] + 3 * d * cfg["shared_intermediate_size"]
    kinds = cfg["layer_types"]
    return kinds.count("mamba") * mamba + kinds.count("attention") * attn + len(kinds) * ffn + d * v


def expert_params_per_row(cfg: dict) -> int:
    """One routed expert's product parameters, met once by each row it computes."""
    return 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def ssd_forward_flops(rows: int, seq: int, cfg: dict) -> int:
    """Forward flops of the SSD's products over ``rows`` sequences of
    ``seq`` tokens, in the Mamba-2 layers: within a chunk of Q tokens,
    for each of its Q(Q+1)/2 causal (t, s) pairs, C_t . B_s (2N a group)
    and the weighted x_s into y_t (2P a head); across chunks, each chunk's
    state from its tokens and each token's read of the state entering its
    chunk (2PN a head and token, each)."""
    q = cfg["mamba_chunk_size"]
    h, p, n, g = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_n_groups"]
    pairs = q * (q + 1) // 2
    chunk = pairs * (2 * g * n + 2 * h * p) + 2 * (2 * q * h * p * n)
    return rows * (seq // q) * chunk * cfg["layer_types"].count("mamba")


def train_step_flops(cfg: dict, rows: int, seq: int, held_rows: float) -> float:
    """A training step's model flops: ``rows`` sequences of ``seq`` tokens
    through the dense products, attention and the SSD, and ``held_rows``
    (the step's rows computed by held experts, over every layer) through
    one expert's products."""
    attn = counts.causal_attention_flops(rows, seq, cfg["num_attention_heads"],
                                         cfg["hidden_size"] // cfg["num_attention_heads"],
                                         cfg["layer_types"].count("attention"))
    return (6 * dense_matmul_params(cfg) * rows * seq + 6 * expert_params_per_row(cfg) * held_rows
            + 3 * attn + 3 * ssd_forward_flops(rows, seq, cfg))
