"""PyTorch/CUDA port of the CGRA toolchain (``repro``'s counterpart).

The JAX package ``repro`` is the reference; this package mirrors its module
names and public API, imports neither ``jax`` nor ``repro``, and runs its
execution path on an NVIDIA GPU through hand-written CUDA kernels
(``repro_torch.kernels``).  Importing it initialises no CUDA context.
"""
