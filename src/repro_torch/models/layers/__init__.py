"""Layers of the decoder."""
