"""gemma3-1b [hf:google/gemma-3-1b-pt]

26L, d_model=1152, 4 heads (GQA kv=1, head_dim=256), d_ff=6912 (GeGLU),
vocab=262144.  5:1 local:global attention; locals use sliding window 512 with
RoPE base 10k, globals are full attention with RoPE base 1M (128k context).
26 = 4 x (5 local + 1 global) + 2 local tail.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=512, rope_base=10_000.0)
_GLOBAL = LayerSpec(kind="attn", window=None, rope_base=1_000_000.0)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    pattern=(_LOCAL,) * 5 + (_GLOBAL,),
    n_rep=4,
    tail=(_LOCAL, _LOCAL),
    use_qk_norm=True,
    long_context_mode="window",
    long_context_window=4096,
)
