"""Operators of the port: the hand-written CUDA kernels (built at first
use, never at import) with their plain PyTorch versions, and the plain
PyTorch graph ops around them."""
