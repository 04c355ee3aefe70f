"""Checkpoints in the reference's layout: npz payloads and a JSON manifest."""
