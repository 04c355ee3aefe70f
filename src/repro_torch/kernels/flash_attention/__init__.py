"""``flash_attention``: the CUDA kernel (``csrc/``), its wrapper (``ops``) and
its plain PyTorch versions (``ref``)."""
