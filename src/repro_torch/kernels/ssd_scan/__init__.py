"""Mamba-2 SSD scan: CUDA kernel ``csrc/ssd_scan.cu`` for the intra-chunk
part, its plain PyTorch version and the sequential oracle."""
