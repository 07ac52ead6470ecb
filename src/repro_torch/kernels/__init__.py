"""Hand-written CUDA kernels for Hopper (``kv_block_copy``,
``flash_attention``, ``offload_quant``), with their plain PyTorch versions
(``ref``) and the builder that compiles ``csrc/`` (``build``)."""
