"""Static analysis of lowered configurations (the compile-time verifier)."""
