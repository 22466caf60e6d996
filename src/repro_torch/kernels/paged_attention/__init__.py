"""Decode attention over a paged KV pool: CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version."""
