"""The plain reference: each model family's forward pass, loss and AdamW in
plain PyTorch, computed in float32 with TF32 off, from the weights and
inputs the harness makes from the seed.  It imports nothing of
``repro_torch``, ``repro`` or ``jax``; the chunked SSD and WKV are frozen
copies of the port's plain versions (``scans.py``).  ``lowp.py`` puts every
weight product through fp8 (e4m3): the control that the correctness limits
must reject."""
