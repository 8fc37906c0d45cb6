"""Frozen counts: operations, bytes and parameters from shapes, and the
H100's published peaks."""
