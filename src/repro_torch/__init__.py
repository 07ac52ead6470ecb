"""TENSILE's serving plane in PyTorch, with hand-written CUDA kernels for
Hopper.

A port of the JAX package ``repro``: module names mirror it so each
counterpart is easy to find, but nothing here imports JAX or ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
