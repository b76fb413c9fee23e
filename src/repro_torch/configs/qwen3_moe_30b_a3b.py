"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk-norm
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    layer_pattern=(LayerDesc(kind="attn", moe=True),),
    moe_experts=128, moe_top_k=8, moe_d_ff=768,
    qk_norm=True, rope_theta=1e6, max_seq=32768,
)
