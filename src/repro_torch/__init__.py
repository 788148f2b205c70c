"""SEINE in PyTorch, with hand-written CUDA kernels for Hopper: the query
phase (lookup, first-stage retrieval, the retrievers) and the offline
build (corpus to segment inverted index).

The port of ``repro`` (JAX, Pallas on TPU) to PyTorch on one NVIDIA H100.
It mirrors ``repro``'s layout module for module and imports neither
``jax`` nor ``repro``: data crosses between the two packages as numpy
arrays or through the on-disk index format (``repro_torch.ckpt``).

Every entry point that creates tensors takes ``device=`` and defaults to
``cuda``; without a GPU it raises rather than falling back to the CPU.
The tests pass ``device="cpu"``, where every kernel wrapper runs its
plain PyTorch version instead.
"""
from .kernels.utils import resolve_device

__all__ = ["resolve_device"]
