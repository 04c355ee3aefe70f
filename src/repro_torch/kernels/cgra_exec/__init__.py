"""``cgra_exec``: the CUDA kernel (``csrc/``), its wrapper (``ops``) and its
plain PyTorch version (``ref``)."""
