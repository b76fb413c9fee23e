"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave
(attention at offset 4, period 8), MoE 16e top-2 every other layer
[arXiv:2403.19887; hf]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

def _desc(i: int) -> LayerDesc:
    kind = "attn" if i % 8 == 4 else "ssm"
    return LayerDesc(kind=kind, moe=(i % 2 == 1))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    layer_pattern=tuple(_desc(i) for i in range(8)),
    moe_experts=16, moe_top_k=2,
    ssm_state=128, ssm_expand=2, ssm_headdim=64,
    max_seq=262144,
)
