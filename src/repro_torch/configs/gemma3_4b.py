"""gemma3-4b [dense] — 5:1 local:global attention (window 1024), 128k ctx
[hf:google/gemma-3-1b-pt scaled; unverified]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

_LOCAL = LayerDesc(kind="attn", window=1024)
_GLOBAL = LayerDesc(kind="attn", window=None)

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    layer_pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope_theta=1e6, tie_embeddings=True, max_seq=131072,
)
