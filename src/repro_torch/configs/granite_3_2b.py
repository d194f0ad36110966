"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]

40L, d_model=2048, 32 heads (GQA kv=8, head_dim=64), SwiGLU d_ff=8192,
vocab=49155.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    **uniform_pattern(LayerSpec(kind="attn"), 40),
)
