"""Interop with the reference TF1 implementation (checkpoint import)."""
