"""Interop of the port (so far: the pretrained-checkpoint checksums)."""
