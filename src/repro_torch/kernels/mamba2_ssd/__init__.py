"""``mamba2_ssd``: the CUDA kernel of the chunked Mamba-2 SSD scan
(``csrc/``), its wrapper (``ops``) and its plain PyTorch version (``ref``)."""
