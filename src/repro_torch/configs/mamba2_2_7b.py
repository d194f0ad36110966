"""mamba2-2.7b [arXiv:2405.21060]

64L, d_model=2560, attention-free SSD (state-space duality) mixer,
ssm_state=128, head_dim=64, expand=2, vocab=50280.  Sub-quadratic natively:
long_500k decode runs the recurrent state update (O(1) in sequence length).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    long_context_mode="native",
    train_micro_batch=16,
    **uniform_pattern(LayerSpec(kind="ssm"), 64),
)
