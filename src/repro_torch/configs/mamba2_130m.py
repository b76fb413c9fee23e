"""mamba2-130m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab=50280,
    layer_pattern=(LayerDesc(kind="ssm"),),
    ssm_state=128, ssm_expand=2, ssm_headdim=64,
    tie_embeddings=True, max_seq=1048576,
)
