"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Every kernel package holds ``ref.py`` (dense PyTorch with the JAX oracle's
semantics) and ``ops.py`` (the public wrapper).  A wrapper runs the plain
version for tensors on the CPU, launches the CUDA kernel (``csrc/``) for
tensors on a GPU or raises, and counts its launches.  ``impl="plain"`` forces
the plain version, for comparing the two on the card.
"""
