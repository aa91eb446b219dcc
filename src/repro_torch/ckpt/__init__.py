"""Atomic, manifest-verified checkpoints in the reference's layout."""
