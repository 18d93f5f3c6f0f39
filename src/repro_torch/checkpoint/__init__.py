"""Checkpoints in the reference's layout."""
