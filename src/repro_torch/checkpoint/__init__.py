"""Checkpoints (counterpart of ``repro.checkpoint``), on the
reference's on-disk format."""
