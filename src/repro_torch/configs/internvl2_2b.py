"""internvl2-2b [arXiv:2404.16821]

VLM: InternViT-300M vision encoder + MLP projector + InternLM2-1.8B language
backbone.  Per the modality carve-out, the ViT is a stub — input_specs()
provides precomputed patch embeddings (B, 256, 1024); the framework owns the
projector (1024 -> d_model) and the language decoder: 24L, d_model=2048,
16 heads (GQA kv=8, head_dim=128), SwiGLU d_ff=8192, vocab=92553.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    frontend="vision_stub",
    n_patches=256,
    d_vision=1024,
    train_micro_batch=16,
    **uniform_pattern(LayerSpec(kind="attn"), 24),
)
