"""Fused pFedSOP round-start update: CUDA kernel pair + plain version."""
