"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    layer_pattern=(LayerDesc(kind="attn"),),
    nonparametric_ln=True, tie_embeddings=True, max_seq=4096,
)
