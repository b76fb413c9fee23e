"""Model configuration schema.

A ModelConfig fully determines the architecture. Heterogeneous stacks
(hybrid SSM/attention, local:global window ratios, MoE interleaves) are
expressed via ``layer_pattern`` — a repeating period of LayerDesc entries;
models/transformer.py scans over full periods (compile-time-compact HLO)
and unrolls the remainder (n_layers % len(pattern)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str = "attn"               # "attn" | "ssm"
    window: Optional[int] = None     # sliding-window size (None = global)
    moe: bool = False                # MoE FFN instead of dense MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # layer pattern (repeated); default: homogeneous global attention
    layer_pattern: tuple = (LayerDesc(),)

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # 0 -> d_ff
    capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"     # "einsum" | "gather" (see models/moe.py)

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # attention details
    qk_norm: bool = False
    nonparametric_ln: bool = False   # OLMo-style LN without params
    mrope: bool = False              # Qwen2-VL multimodal RoPE
    mrope_sections: tuple = (16, 24, 24)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # encoder-decoder (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500              # encoder frames (audio stub length)

    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None

    # training defaults
    max_seq: int = 8192

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        if self.moe_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows padded to a 256 multiple: unpadded vocabs
        (e.g. mamba2's 50280) cannot vocab-shard on a 16-way TP axis, which
        forces a full-logits all-reduce over DP (observed 211 GB/step in the
        baseline dry-run — §Perf iteration 3)."""
        return -(-self.vocab // 256) * 256

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    def plan(self) -> list[LayerDesc]:
        """Per-layer descriptors for the full stack."""
        reps = -(-self.n_layers // self.period)
        return (list(self.layer_pattern) * reps)[:self.n_layers]

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)

    # ---- parameter counting (roofline MODEL_FLOPS = 6*N*D) ----
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        mlp_dense = 3 * d * self.d_ff
        moe_total = self.moe_experts * 3 * d * self.moe_d_ff + d * self.moe_experts
        moe_active = self.moe_top_k * 3 * d * self.moe_d_ff + d * self.moe_experts
        d_inner = self.ssm_expand * d
        H = d_inner // self.ssm_headdim if self.ssm_state else 0
        ssm = (d * (2 * d_inner + 2 * self.ssm_state + H)
               + self.ssm_conv * (d_inner + 2 * self.ssm_state)
               + 3 * H + d_inner + d_inner * d) if self.ssm_state else 0
        total = active = 0
        for desc in self.plan():
            blk = attn if desc.kind == "attn" else ssm
            ffn_t = moe_total if desc.moe else mlp_dense
            ffn_a = moe_active if desc.moe else mlp_dense
            total += blk + ffn_t
            active += blk + ffn_a
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        enc = cross = 0
        if self.enc_dec:
            # encoder layers (attn + dense mlp) + cross-attn in decoder;
            # kept separate: encoder params see enc_seq tokens, not T
            enc = self.enc_layers * (attn + mlp_dense)
            cross = self.n_layers * attn
            total += enc + cross
            active += enc + cross
        return {"total": total + emb, "active": active + emb,
                "embedding": emb, "encoder": enc, "cross": cross}
