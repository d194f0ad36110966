"""gemma2-9b [arXiv:2408.00118]

42L, d_model=3584, 16 heads (GQA kv=8, head_dim=256), GeGLU d_ff=14336,
vocab=256000.  Alternating local (window 4096) / global attention,
attention logit softcap 50.0 and final-logit softcap 30.0.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=4096, rope_base=10_000.0)
_GLOBAL = LayerSpec(kind="attn", window=None, rope_base=10_000.0)

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    pattern=(_LOCAL, _GLOBAL),
    n_rep=21,
    tail=(),
    attn_softcap=50.0,
    final_softcap=30.0,
    long_context_mode="window",
    long_context_window=4096,
)
