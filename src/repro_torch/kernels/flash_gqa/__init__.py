"""Causal GQA flash attention: CUDA forward (with the LSE residual) and the
two-pass backward, their plain versions, and the window-pruned grid
helpers."""
