"""Model configuration for the assigned architecture zoo.

One frozen dataclass covers all ten families; family-specific sub-configs are
None when unused.  Instances are hashable (usable as jit static args).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "RGLRUConfig",
    "ModelConfig",
]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # expert hidden size
    num_shared: int = 0
    d_shared: int = 0  # shared-expert hidden size (0 -> same as d_expert)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    aux_loss_coef: float = 0.001
    # layers [0, first_k_dense) use a dense FFN instead of MoE (DeepSeek-V3
    # keeps the first 3 layers dense).
    first_k_dense: int = 0
    d_ff_dense: int = 0  # hidden of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block."""

    lru_width: int = 2560
    d_conv: int = 4
    window: int = 2048  # sliding window of the interleaved local attention
    c_exponent: float = 8.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention flavour
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: int = 0  # 0 -> full attention
    mrope: bool = False  # qwen2-vl multimodal rotary (t/h/w sections)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # halves of head_dim
    # block pattern for hybrids: tuple of "attn" | "local" | "rglru" | "ssm"
    # cycled over n_layers; empty -> all "attn" (or "ssm" for family=ssm)
    pattern: tuple[str, ...] = ()
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    # encoder-decoder (seamless): encoder layer count (decoder = n_layers)
    enc_layers: int = 0
    # modality frontend stub: inputs arrive as embeddings, not token ids
    frontend: Literal["none", "audio", "vision"] = "none"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    # multi-token prediction (DeepSeek-V3 MTP, depth 1): one extra block that
    # predicts token t+2 from (h_t, emb(t+1)); adds mtp_weight * CE to loss.
    mtp: bool = False
    mtp_weight: float = 0.3
    # embedding/head vocab dim is padded up to a multiple of this so the
    # vocab axis shards evenly over 'model' (padded logits are masked).
    vocab_pad_to: int = 16
    # streaming cross-entropy: the loss is computed over sequence chunks
    # (remat'd scan) so the [B, S, vocab] f32 logits are never materialised.
    # 0 = auto (chunk count from S*vocab), 1 = unchunked.
    ce_chunks: int = 0
    # training/serving knobs
    max_seq: int = 8192
    dtype: str = "bfloat16"
    remat: str = "full"  # "none" | "full" | "dots"
    logits_softcap: float = 0.0

    # ------------------------------------------------------------------ utils
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = max(self.vocab_pad_to, 1)
        return -(-self.vocab // m) * m

    def block_types(self) -> tuple[str, ...]:
        """Resolved per-layer block type list of length n_layers."""
        if self.pattern:
            reps = -(-self.n_layers // len(self.pattern))
            return (self.pattern * reps)[: self.n_layers]
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.moe is not None:
            kinds = []
            for i in range(self.n_layers):
                kinds.append("attn_dense" if i < self.moe.first_k_dense else "attn_moe")
            return tuple(kinds)
        return ("attn",) * self.n_layers

    def scan_groups(self) -> tuple[tuple[str, int], ...]:
        """Consecutive (block_type, count) runs — each becomes one lax.scan.

        For cyclic patterns (e.g. recurrentgemma's rglru/rglru/local) the unit
        is the full cycle so one scan covers all repetitions.
        """
        types = self.block_types()
        if self.pattern and len(set(self.pattern)) > 1:
            # scan over whole cycles; leftover layers become their own runs
            cyc = len(self.pattern)
            full = self.n_layers // cyc
            groups = [("cycle:" + "|".join(self.pattern), full)] if full else []
            for t in types[full * cyc :]:
                groups.append((t, 1))
            return tuple(_merge_runs(groups))
        runs: list[tuple[str, int]] = []
        for t in types:
            if runs and runs[-1][0] == t:
                runs[-1] = (t, runs[-1][1] + 1)
            else:
                runs.append((t, 1))
        return tuple(runs)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops)."""
        from . import lm  # lazy: avoid cycle

        return lm.param_count(self)

    def active_param_count(self) -> int:
        from . import lm

        return lm.param_count(self, active_only=True)


def _merge_runs(groups: list[tuple[str, int]]) -> list[tuple[str, int]]:
    out: list[tuple[str, int]] = []
    for t, c in groups:
        if out and out[-1][0] == t:
            out[-1] = (t, out[-1][1] + c)
        else:
            out.append((t, c))
    return out
