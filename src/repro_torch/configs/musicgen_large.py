"""musicgen-large [arXiv:2306.05284]

Decoder-only transformer over EnCodec tokens: 48L, d_model=2048, 32 heads
(kv=32, head_dim=64), d_ff=8192, vocab=2048 per codebook, 4 codebooks with
the delay interleaving pattern.  Per the modality carve-out, the EnCodec
conv codec is a stub: the model consumes 4 parallel integer token streams
(summed codebook embeddings) and produces 4 logit heads.  MusicGen's learned
absolute positions are replaced with RoPE (TPU-idiomatic; see DESIGN.md §8).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio_codebooks",
    n_codebooks=4,
    # decode_32k cache is 1.6 TB at bf16 (48L x 32 kv x 32k x 128 batch);
    # int8 KV quantisation halves it to fit v5e (EXPERIMENTS.md §Perf)
    kv_quant=True,
    **uniform_pattern(LayerSpec(kind="attn"), 48),
)
