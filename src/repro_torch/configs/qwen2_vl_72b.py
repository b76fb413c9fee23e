"""qwen2-vl-72b [vlm] — M-RoPE, dynamic-resolution vision frontend (STUB:
input_specs provides precomputed patch embeddings) [arXiv:2409.12191; hf]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    layer_pattern=(LayerDesc(kind="attn"),),
    mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6, max_seq=32768, frontend="vision",
)
