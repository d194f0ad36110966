"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base family]

40L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), SwiGLU d_ff=12800,
vocab=49155.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-8b-base",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab_size=49_155,
    # activation-memory knob: mb=16 halves per-iteration activations
    # (T=16 local-SGD iterations keep the global batch at 256)
    train_micro_batch=16,
    **uniform_pattern(LayerSpec(kind="attn"), 40),
)
