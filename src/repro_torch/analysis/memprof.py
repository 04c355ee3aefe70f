"""Per-op memory-traffic profile of a dry-run cell (the JAX package's
``analysis/memprof.py``, in PyTorch).

    PYTHONPATH=src python -m repro_torch.analysis.memprof --arch gemma3-27b \\
        --shape train_4k [--overrides '{"shard_strategy":"fsdp"}']
"""
from repro_torch.analysis.collectives import memory_main

if __name__ == "__main__":
    memory_main()
