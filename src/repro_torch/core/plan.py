"""Hardware constants the serving session books transfers against.

Only ``MachineProfile`` is ported in this slice.  Its defaults describe
one NVIDIA H100 SXM: the device facts come from NVIDIA's data sheet, the
host-link figures from the measurement ``chip_smoke.py`` makes and prints
(pinned host memory over PCIe).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MachineProfile:
    device_memory_bytes: int = 80 * 10 ** 9          # H100 SXM HBM3
    compute_flops: float = 989e12                    # dense bf16 tensor cores
    mem_bw: float = 3.35e12                          # HBM B/s
    # host<->device copies of pinned memory, measured by chip_smoke.py on
    # an H100 80GB HBM3 (700 W limit): the slower direction's rate at
    # 256 MiB (host to device), the median host-clock time of a 512-byte
    # copy ending in a synchronisation (device to host), and the added cost
    # of each further small copy queued behind that one synchronisation
    host_link_bw: float = 51.2e9
    host_link_latency: float = 24.2e-6
    dma_batch_overhead: float = 6.6e-6
