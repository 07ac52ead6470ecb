"""Hand-written CUDA kernels for Hopper (``kv_block_copy``,
``flash_attention``, ``offload_quant``, ``ssd_scan``), with their plain
PyTorch versions (``ref``) and the builder that compiles ``csrc/``
(``build``)."""
