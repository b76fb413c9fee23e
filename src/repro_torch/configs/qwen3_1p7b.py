"""qwen3-1.7b [dense] — qk-norm, GQA [hf:Qwen/Qwen3-1.7B; hf]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, head_dim=128,
    layer_pattern=(LayerDesc(kind="attn"),),
    qk_norm=True, rope_theta=1e6, tie_embeddings=True, max_seq=32768,
)
