"""whisper-medium [audio] — enc-dec; conv frontend is a STUB (input_specs
provides precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    layer_pattern=(LayerDesc(kind="attn"),),
    enc_dec=True, enc_layers=24, enc_seq=1500,
    frontend="audio", max_seq=448,
)
