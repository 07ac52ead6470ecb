"""Continuous-batching LM serving over the port's ServingEngine: prefill
-> insert -> chunked cohort decode, with KV-cache residency scheduling
when a budget is given (the port's counterpart of
``examples/serve_lm.py``).  It runs on the CUDA card by default:

    PYTHONPATH=src python examples/serve_lm_torch.py --arch tinyllama-1.1b \
        --max-sequences 4 --prompt-len 8 --gen 8 --trace burst \
        --budget-kb 24 [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.serving.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
