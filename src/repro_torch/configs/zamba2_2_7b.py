"""zamba2-2.7b [arXiv:2411.15242]

Hybrid: 54 layers, d_model=2560, Mamba2 backbone (ssm_state=64) with a
SHARED attention+MLP block (32 heads, kv=32, head_dim=80, d_ff=10240,
params reused at every invocation) interleaved every 6th layer:
pattern = (ssm x5, shared_attn) x 9.  vocab=32000.  Zamba2's per-invocation
LoRA deltas on the shared block are omitted (see DESIGN.md §8).
Sub-quadratic natively via the SSM backbone + single shared windowless
attention over the running context: for long_500k the shared block uses the
sliding-window variant while the SSM path is recurrent.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    train_micro_batch=16,
    pattern=(LayerSpec(kind="ssm"),) * 5 + (LayerSpec(kind="shared_attn"),),
    n_rep=9,
    tail=(),
    long_context_mode="native",
    long_context_window=4096,
)
