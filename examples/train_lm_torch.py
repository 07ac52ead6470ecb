"""End-to-end LM training driver of the PyTorch port: trains a reduced
assigned-architecture config with the full substrate — data pipeline with
prefetch, AdamW, TENSILE memory planning, async checkpointing and
restart-on-failure — on the CUDA card, or on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --arch tinyllama-1.1b \
        --steps 300 --tensile-budget-mb 64 --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main

if __name__ == "__main__":
    sys.exit(main())
