"""Hand-written CUDA kernels for Hopper (``kv_block_copy``,
``flash_attention``), with their plain PyTorch versions (``ref``) and the
builder that compiles ``csrc/`` (``build``)."""
