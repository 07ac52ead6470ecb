"""One train step with ``offload_opt_state`` under the (1, 1) host mesh on
the card, reduced TinyLlama, from the source tree given as the first
argument: whether it raises, and where the moments are after it.

    python3 scripts/offload_mesh_probe.py src
    python3 scripts/offload_mesh_probe.py <an unpacked older tree>/src

prints one line, ``PROBE {json}``.  Needs a CUDA card."""
import json
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import init_world, make_host_mesh  # noqa: E402
from repro_torch.launch.sharding import MeshRules, shard_params  # noqa: E402
from repro_torch.launch.steps import (TrainStepConfig,  # noqa: E402
                                     build_train_step, opt_state_for)
from repro_torch.models.registry import get_model  # noqa: E402

init_world("cuda")
cfg = get_config("tinyllama-1.1b").reduced()
api = get_model(cfg, "cuda")
rules = MeshRules(make_host_mesh(device="cuda"), cfg=cfg)
params = shard_params(api.init(torch.Generator(device="cuda").manual_seed(0)),
                      rules)
opt = opt_state_for(params)
rng = np.random.default_rng(0)
batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64),
                                          dtype=np.int32)).cuda()
         for k in ("tokens", "labels")}
step = build_train_step(api, TrainStepConfig(offload_opt_state=True),
                        rules=rules)
out = {"src": sys.argv[1], "torch": torch.__version__}
try:
    _, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    leaves = list(opt.mu.values()) + list(opt.nu.values())
    out["raised"] = None
    out["moments"] = sorted({
        f"{type(t).__name__} on "
        f"{getattr(t, 'local', t).device}, pinned "
        f"{getattr(t, 'local', t).is_pinned()}" for t in leaves})
    out["loss"] = float(m["loss"])
except Exception as e:  # noqa: BLE001 - the finding is the exception
    out["raised"] = f"{type(e).__name__}: {str(e)[:400]}"
print("PROBE " + json.dumps(out))
torch.distributed.destroy_process_group()
