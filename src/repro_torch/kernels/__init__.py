"""Hand-written Hopper kernels of the port, one package each, with the
shared ``nvcc`` builder (``build``)."""


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a ``DTensor``: a kernel
    wrapper takes one device's tensors, and a sharded step reaches it only
    through the models' ``local_map``, on each device's shard."""
    import torch.distributed as dist
    if not dist.is_available():
        return
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes one device's tensors, not a DTensor "
                        f"(a sharded step calls it per device through "
                        f"local_map)")
