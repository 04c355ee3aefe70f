"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at the full 700 W power limit."""

#: dense tensor-core FLOP/s by dtype; float32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: device memory in bytes (80 GB)
MEMORY_BYTES = 80e9


def roofline(flops, nbytes, dtype):
    """(ms, bound_by): the larger of the operations at ``dtype``'s peak and
    the bytes at HBM's rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
