"""PyTorch/CUDA port of the EWSJF serving stack, for one NVIDIA H100.

The package mirrors the JAX package's layout (``configs``, ``core``,
``models``, ``kernels``, ``serving``, ``launch``, ``obs``) so every module
has a named counterpart there.  It imports neither JAX nor the JAX package:
the pure-Python scheduler, config and observability modules are copies.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
no GPU is present; tests pass ``device="cpu"``, where every kernel wrapper
runs its plain PyTorch version.
"""
