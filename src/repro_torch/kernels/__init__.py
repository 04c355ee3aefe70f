"""Hand-written Hopper kernels of the port, one package each, with the
shared ``nvcc`` builder (``build``)."""
