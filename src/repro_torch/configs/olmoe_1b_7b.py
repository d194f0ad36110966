"""olmoe-1b-7b [arXiv:2409.02060]

16L, d_model=2048, 16 heads (kv=16, head_dim=128), vocab=50304.
MoE FFN every layer: 64 experts, top-8, expert d_ff=1024 (SwiGLU).
~1B active / ~7B total parameters.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50_304,
    n_experts=64,
    top_k=8,
    expert_ff=1024,
    **uniform_pattern(LayerSpec(kind="moe"), 16),
)
