"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions
(``ref``) and the builder that compiles ``csrc/`` (``build``)."""
