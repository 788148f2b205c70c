"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; ``utils.build_all`` compiles them all at once."""
from .utils import build_all

__all__ = ["build_all"]
