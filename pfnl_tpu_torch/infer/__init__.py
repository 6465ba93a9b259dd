"""Inference API of the port."""
