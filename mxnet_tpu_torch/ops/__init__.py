"""Operators of the port that carry a hand-written CUDA kernel."""
from . import paged_attention  # noqa: F401
