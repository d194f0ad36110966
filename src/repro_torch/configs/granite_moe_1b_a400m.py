"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]

24L, d_model=1024, 16 heads (GQA kv=8, head_dim=64), vocab=49155.
MoE FFN: 32 experts, top-8, expert d_ff=512 (SwiGLU).  ~400M active params.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    n_experts=32,
    top_k=8,
    expert_ff=512,
    **uniform_pattern(LayerSpec(kind="moe"), 24),
)
