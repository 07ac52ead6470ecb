"""DEPRECATED serving driver -- forwards to ``repro_torch.serving.cli``.

The port's counterpart of the JAX package's ``launch/serve.py`` shim.  The
serving plane is :class:`repro_torch.serving.engine.ServingEngine` (the
``prefill(prompt) -> insert(slot) -> generate()`` runtime),
:class:`repro_torch.serving.session.ServeSession` (continuous batching with
KV-cache residency scheduling) and ``repro_torch.serving.cli`` (the
flag-parsing entry point, on the CUDA card unless ``--device cpu``).

Old flags are translated where they map (``--batch`` becomes
``--max-sequences``):

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 2 --device cpu
"""
from __future__ import annotations

import sys
import warnings


def main(argv=None) -> int:
    warnings.warn(
        "repro_torch.launch.serve is deprecated; use "
        "repro_torch.serving.cli (the ServingEngine-based driver) instead",
        DeprecationWarning, stacklevel=2)
    from ..serving.cli import main as serving_main
    argv = list(argv) if argv is not None else sys.argv[1:]
    argv = ["--max-sequences" if a == "--batch" else
            a.replace("--batch=", "--max-sequences=", 1) if
            a.startswith("--batch=") else a for a in argv]
    return serving_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
