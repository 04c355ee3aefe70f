"""Frozen work counts: the H100's published peaks, the least operations
and bytes of each scan and attention call from its shapes, and each model
family's FLOPs a token."""
