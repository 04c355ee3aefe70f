"""``rwkv6``: the CUDA kernel of the chunked RWKV-6 WKV (``csrc/``), its
wrapper (``ops``) and its plain PyTorch versions (``ref``)."""
