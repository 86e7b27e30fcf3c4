"""Checkpoints of the port, in the reference's on-disk layout."""
