"""The CGRA toolchain: ADL fabrics, DFG, modulo mapper, lowering, simulator."""
