"""Fused RMSNorm: CUDA forward kernel + plain version; autograd of the
reference for the backward."""
