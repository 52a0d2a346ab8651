"""Tensor functions and kernel wrappers."""
