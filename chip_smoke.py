"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
its paths at the full width of TinyLlama-1.1B, then of Mamba-2 780M,
Moonlight-16B-A3B and whisper-base (bf16, random weights from seed 0):

1. serving: the KV gather/scatter kernel bit-exact against its plain
   version on 2-D pools, on single cache leaves and on one call over
   every slotted leaf of both models' caches (``check_kernels``,
   ``check_leaves``); its times at TinyLlama's two leaves and Mamba-2's
   fp32 state leaf (``time_leaves``); the pinned
   host link, the reduced decode card-vs-CPU, then ``ServingEngine.serve``
   twice, unbudgeted (the golden run) and under a KV budget of about two
   of four sequences with the batched transfer path.  The budgeted run
   must reproduce the golden tokens bit for bit, with no OOM, with
   evictions, and through both kernels, one launch per batched transfer;
   one batched 2-slot restore of each model is profiled in a fresh process
   (``profile_restore``, both models in one).
2. the LM forward and training: the flash-attention kernel against its
   plain version at the reference's sweep, its bf16 twins (the tensor-core
   path at every padded head dim) and the prefill's shape, two calls
   bit-identical; the
   prefill (B 4, S 2048) through ``build_prefill_step`` with the kernel,
   which must launch it once per layer and agree with the plain attention
   path; the reduced fp32 forward card-vs-CPU; 4 train steps (B 4,
   S 1024) through ``build_train_step``, whose loss must fall; the reduced
   fp32 train step card-vs-CPU; and the kernel's times at the prefill's
   shape and at a D 128 shape, each beside ``scaled_dot_product_attention``,
   with the bf16 kernel's ptxas registers and spills.
3. Mamba-2 780M, the SSM slice: the SSD intra-chunk kernel against its
   plain version at the reference's sweep, a ragged chunk, the kernel's
   edges and the prefill's shape, two calls bit-identical (``check_ssd``);
   at full width and SERVE_LAYERS of its 48 layers, the serve pair as
   above, whose
   budgeted run swaps the positionless SSM state through both KV kernels
   (``serve_ssm``); the decode step's profile; the prefill (B 4, S 2048)
   through the kernel, once per layer, against the plain chunked path
   (``prefill_ssm``); 4 train steps (B 4, S 1024) on the plain path
   (``train_ssm``); reduced fp32 decode, forward and train step
   card-vs-CPU; the kernel's times (``time_ssd``) and, in a fresh
   process, its device time, one device kernel per call
   (``ssd_device_ms``); with its ptxas registers and spills and its SASS
   tensor-core instruction counts.
4. TENSILE, the paper's own loop: the quantize/dequantize kernels
   bit-exact against their plain versions on every route of a compressed
   swap (card to card, card to a packed pinned buffer, that buffer to the
   card), from aligned tensors and from views one element into their
   storage, the packed buffer written whole over a sentinel
   (``check_quant``); their times card to card, and a compressed swap
   each way by the executor's old route (staged on the card, two copies)
   and its new one (one launch), in turns, beside the link bound
   (``time_quant``); the host routes' CTA cap sweep
   (``quant_cta_sweep``); the
   quickstart MLP captured, planned and executed, its executor peak and
   decision trace equal to the simulator's (``tensile_mlp``); then the
   full-width train step (B 4, S 1024, no block remat; TENSILE_LAYERS of
   the 22 layers) captured on fake
   tensors, its operator latencies measured by one unscheduled run, planned
   with the compressed pass first under the tightest budget that plan
   reaches, and executed for 2 iterations with swaps to pinned host memory
   on a copy stream (``tensile_train``).  The same budget's uncompressed
   ``tensile`` plan must give results bit-identical to the unscheduled
   run, the compressed plan results within stated tolerances, the
   card's allocator peak must sit within 5 % of the executor's ledger
   peak and below the unscheduled run's, each compressed swap must be one
   kernel launch, and the profiled compressed step may copy between host
   and card only for plain swaps, packed buffers above the zero-copy size
   and the graph's own host constants.
5. The multi-job runtime (``multi_job``, in a fresh process): one
   ``GlobalController`` on the card's profile (``tensile+autoscale``,
   async swaps, priority arbitration in ``preempt`` mode) runs job A (the
   train step above at CONTROLLER_LAYERS of its 22 layers, full width, 2
   iterations), job B (the same model at B 2, 2
   iterations, captured before A starts and submitted while A is
   mid-iteration) and job S (the serve phase's serve, through a serve
   factory registered here), with each job's slice set by its priority:
   the train jobs' at MULTI_SLICE of their unscheduled planned peaks, the
   serve job's at MULTI_SERVE_SLICE of its KV demand.  Gates: every job
   done; both train jobs' final parameters and moments bit-identical to
   the same iterations run alone and unscheduled; the global ledger peak
   within the capacity and the allocator's within 1.05 x; the serve job's
   tokens the golden run's, with evictions, no OOM and both KV kernels
   launched.  One concurrent window is profiled (its device idle share).
   Then ``hot_swap_full_width``: job A alone from an empty plan, a plan
   for 0.8 of its planned peak requested at its first safe point after op
   0, which must be spliced in once, swap out, and leave the outputs
   bit-identical to the unscheduled step; and the cost of one copy stream
   for every job (``shared_copy_stream_cost``).
6. The experience plane, two fresh processes over one store in a
   temporary directory outside the checkout, both given the link rate this
   process measured (it salts every fingerprint).  ``experience_cold``: a
   controller as ``multi_job``'s (``priority`` policy, one job live) over
   the empty store, with a drift monitor, each job held to its slice
   (``hold_slices``) and a cost model of the card's measured calibration
   with the executor's per-operator floor as its overhead
   (``executor_floor``), runs job A (the train step above, 2 iterations,
   seed 0) at EXPERIENCE_SLICE of the planned peak of its capture (the
   capture's cost-model latencies: no solo run); a second controller over
   the same store, with no explicit cost model (it starts from the
   calibration A's run stored), runs job B (B 2, 1 iteration, seed 1)
   likewise; then a ``LatencyMLP`` is fitted on the card to A's measured
   operators.  ``experience_warm``: a new controller
   over the store with no explicit cost model captures A, predicts its
   peak and runs it at the cold capacity; then the ``peak`` policy splits
   A and B with and without the store's priors (host only).  Gates: the
   same fingerprint in both processes; the warm prediction is the peak the
   cold run measured, source ``experience``; the warm cost model is the
   stored calibration; A's first warm plan is a verified ``warm-boot``
   within its capacity; no compressed event; A's final parameters and
   moments hash the same in both runs; the cold drift sample exceeds 0.15
   with a WARN event and the warm one is smaller; both samples in the
   store's drift history; no experience failure; B's cost model is the
   calibration A stored; each run's global ledger peak within its capacity
   and the allocator's within 1.05 x (each executor's budget guard waits
   for its swap-outs, or swaps out more, where a plan exceeds the slice or
   its model misjudges the card); the predictor's loss falls and its R² is
   finite.
   Then the service plane (``service``): this process drops three jobs into
   the inbox of a service root outside the checkout with a
   ``ServiceClient`` (A, the cold run's job, 1 iteration; C, the step at B
   3, which the store does not know; S, ``multi_job``'s serve job) and a
   drain request, before the warm run; after its gates a
   ``SchedulerDaemon`` in the warm run's process (``service_daemon``; A's
   capture is that run's graph and sequence with a fresh state), its
   ``GlobalController`` on the card over the experience store (the measured
   link, ``CostModel(calibrate_cuda())`` with the LatencyMLP
   ``experience_cold`` fitted attached, so C's capture prices each operator
   through it; ``tensile+autoscale``, the ``priority`` policy, each slice
   held), runs them: A's slice its cold capacity and S's half its KV demand
   (``multi_job``'s capture of S), the capacity their sum (or what
   admission needs for both predicted peaks).  A ``TraceRecorder`` rides on
   the daemon and the controller's engine; the daemon's admission spans
   time each job's capture and prediction.  Then a crashed daemon's queue
   (one QUEUED, one ADMITTED and one RUNNING MLP job) is recovered on the
   same root by a new daemon.  Gates: through the client, A and S DONE, C
   REJECTED, the recovered jobs DONE; A admitted warm (source
   ``experience``, the peak the store holds), C cold (``cost-model``, its
   no-free bound above the capacity) after a capture whose LatencyMLP
   predictions give a finite, positive iteration time, S at its KV demand;
   A's final state bit-identical to its solo unscheduled run; the global
   ledger peak within the capacity and the allocator's within 1.05 x; S's
   tokens the golden run's, with evictions, no OOM and both KV kernels
   launched (counted from 0 in the daemon's process); the orphan re-queued
   exactly once; ``metrics.prom`` parsing with the core gauges and S's
   tokens/s; the trace valid, with A's op spans (one per operator per
   iteration), DMA transfer spans and a ``job:<state>`` instant for every
   transition, and a ``capture`` span for C and S and a ``predict`` span
   for each of the three.
7. The training launcher (``train_launcher``, in a fresh process), B 4, S
   1024, LAUNCHER_LAYERS of the 22 layers: the launcher's train step
   captured on fake tensors and planned by ``schedule_for_budget`` at
   LAUNCHER_BUDGET of its planned peak; under ``make_remat_policy`` of
   those decisions the loss and gradients must equal the block remat step's
   bit for bit; one step with the moments in pinned host memory
   (``offload_opt_state``) must give the on-card step's parameters and
   moments bit for bit and save at least 0.8 of the moments' bytes of the
   card's allocator peak; int8 error-feedback gradients on one batch, whose
   loss must fall, whose residual must be finite and not zero, and whose
   compression call on the card must equal the CPU's bit for bit; six steps
   of ``resilient_train_loop`` through the ``Prefetcher`` with a checkpoint
   at step 3 (``keep`` 1, in a temporary directory outside the checkout,
   the free disk checked first) and a failure injected once at step 4,
   which must restart once, feed the stream's batches in order and end with
   the state of an unbroken run (sha256); then ``launch.train.main`` itself
   (the reduced width at LAUNCHER_MAIN_SEQ tokens, int8 gradients, a
   TENSILE budget of LAUNCHER_BUDGET of the planned peak of that step's
   capture: ``main`` captures, schedules and prints its decisions, which
   are gated) for LAUNCHER_MAIN_STEPS steps.
8. The MoE slice (``moe``, in a fresh process): reduced fp32 Moonlight,
   Kimi-K2 and Jamba (the SSD and flash kernels in one hybrid block),
   decode, forward and train step card-vs-CPU with every MoE layer's
   expert choices equal on both; the flash kernel at Moonlight's and
   Kimi-K2's (D 112) attention shapes and the KV kernels at Moonlight's
   cache leaves against their plain versions; Moonlight-16B-A3B at full
   width and SERVE_LAYERS of its 48 layers (64 experts top-6) served
   unbudgeted and under a KV budget (golden tokens, no OOM, evictions,
   ceil(leaves / 16) KV launches per batched transfer and kernel) and
   prefilled at B 4 x S 2048 through the flash kernel (one launch per
   layer; each layer within the bf16 per-layer bound; fp32 at
   MOE_TRAIN_LAYERS layers within 1e-3 end to end with equal expert
   choices); 4 train steps at MOE_TRAIN_LAYERS layers, whose loss must
   fall, and that step captured, planned by ``tensile`` at MOE_BUDGET of
   its planned peak and run on ``FxExecutor`` bit-identical to the
   unscheduled step, its allocator within 5 % of its ledger, with
   swap-outs; Kimi-K2's dense prefix layer and one MoE layer with its
   shared expert at full width: a B 1 x S 2048 prefill through the flash
   kernel at D 112 and 4 decode steps.
9. The whisper slice (``whisper``, in a fresh process): the flash kernel
   at whisper's prefill shape (B 16, 375 tokens, 8 heads of 64, MHA;
   ragged tiles) in bf16 and fp32 against its plain version, two calls
   bit-identical, timed beside ``scaled_dot_product_attention``; reduced
   fp32 whisper (2 encoder layers, 1 decoder layer, 160 frames: the
   chunked encoder and cross-attention) forward, decode and train step
   card-vs-CPU; then whisper-base at full width and depth (6 encoder and
   6 decoder layers, bf16, seed 0) on B 16 windows of 1500 frames (30 s
   of audio) and 375 tokens: the prefill through ``build_prefill_step``
   with the flash kernel (6 launches, only in the decoder's causal
   self-attention; per layer and end to end in bf16, and end to end in
   fp32 at full depth, against the plain path); 32 greedy decode steps
   through ``build_serve_step`` against a cache of 448 positions, whose
   fp32 logits must equal the forward over the same tokens; 4 train
   steps with block remat (loss falling, the cross-attention biases,
   which the loss never reads, exactly zero); the functional step
   without remat captured and run under ``tensile`` at 0.7 of its
   planned peak (bit-identical, allocator within 5 % of the ledger,
   swap-outs, what the plan did with the encoder's output); and
   ``launch.train.main --arch whisper-base --full`` for 3 steps.
10. Distribution (``distribution``, in a fresh process): a world of one on
   NCCL (``launch.mesh.init_world``), ``make_host_mesh()`` (a (1, 1)
   ``("data", "model")`` mesh: NCCL runs one rank per card) and
   ``MeshRules`` over it; full-width TinyLlama-1.1B (22 layers, bf16,
   seed 0) as DTensors placed by ``shard_params``: the prefill (B 4 x
   S 2048) under the rules through the flash kernel (22 launches counted
   from 0) with logits bit-identical to the meshless prefill; two train
   steps under the rules (B 4 x S 1024) with loss, parameters and both
   moments bit-identical to two meshless steps, the allocator's peak
   within 5 % of theirs; ``compressed_psum_mean`` over the world on
   64 MiB fp32 bit-equal to ``quantize_dequantize`` (one rank's mean is
   its own quantization); ``reshard_state`` onto a second (1, 1) mesh and
   a checkpoint saved on the mesh restored into a DTensor template, both
   bit-identical; and ``launch.train.main --full --mesh 1,1`` for 3
   steps.  Also two train steps with the moments in pinned
   host memory under the mesh (``HostShard``s placed by
   ``opt_state_shardings(offload=True)``, pinned after each step) and
   two meshless ones, every parameter and moment hash-equal to the
   on-card mesh steps, the allocator's peak lower than the on-card mesh
   step's by at least 0.8 x ``offloaded_bytes``.  The wall ms of the
   prefill and the train step, meshless and under the mesh, on the card
   and with the moments on the host, are printed.  In the same process, ``moe_mesh``:
   full-width Moonlight-16B-A3B at MOE_TRAIN_LAYERS of its 48 layers,
   whose scatter MoE under the rules routes the data shards of the
   tokens (``models.moe._scatter_on_shards``): a bf16 prefill (B 4 x
   S 2048) through the flash kernel (one launch per layer, counted from
   0) and two train steps (B 4 x S 1024), meshless and on the (1, 1)
   mesh, with logits, losses, parameters and both moments bit-identical
   (a per-leaf 64-bit hash on the card) and the allocator's peak within
   5 %; and
   ``serve_mesh``: full-width TinyLlama-1.1B served by
   ``ServingEngine(rules=...)`` on the (1, 1) mesh (its cache placed by
   ``api.cache_axes()``, transfers on the local shards) under the serve
   phase's budget, its tokens the serve phase's golden run's, its
   decision trace, transfer bytes and KV launches that phase's meshless
   budgeted run's, with evictions and no OOM.
11. The dry run (``dryrun_cells`` and ``dryrun_card``): in a fresh
   process beside the distribution phase's, ``launch.dryrun.run_cell`` on
   rank 0 of a 512-rank ``fake`` world on the 16 x 16 mesh for
   TinyLlama-1.1B's ``train_4k``, ``prefill_32k`` and ``decode_32k``,
   Moonlight's ``decode_32k`` and ``train_4k``, Gemma-2B's ``train_4k``
   and Mamba-2's ``long_500k`` (each record's peak, FLOPs, dominant term
   and collective mix printed; the three ``train_4k`` cells must fit the
   card's 80 GB, as the reference's own accounting fits them); then, in the
   distribution phase's process after its gates, full-width
   TinyLlama-1.1B's train step (B 4 x S 1024, block remat), prefill (B 4
   x S 2048) and four decode steps (B 4, a 2048-position cache) on the
   config's default path (plain attention), meshless and under the (1, 1)
   host mesh, each accounted on ``meta`` shells and on the card's tensors.
   Gates: equal FLOP counts on both, and meshless and under the mesh; the
   ledger's predicted peak within 10 % of the allocator's; no collective
   on the (1, 1) mesh.  Each step's CUDA-event time is printed beside the
   roofline's compute and memory seconds.

Every phase raises on failure.  Without a CUDA card the script exits 1
and prints no result.  The last line of standard output is the JSON
device record; the line before it is the kernel table.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch
import torch.utils._pytree as pytree

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import (BudgetArbiter, CapturedJob,  # noqa: E402
                              CostModel, DeviceCalibration, ExperienceStore,
                              FxExecutor, GlobalController, LatencyMLP,
                              MachineProfile,
                              MemoryEngine, device_identity, fingerprint,
                              MemoryScheduler, Pipeline, SchedulerConfig,
                              SchedulingPlan, analyze,
                              build_pipeline, calibrate_cuda,
                              capture_train_step, evaluate, executor_floor,
                              find_safe_points, make_remat_policy,
                              schedule_for_budget, schedule_single, simulate)
from repro_torch.core.passes import (CompressedOffloadPass,  # noqa: E402
                                     RecomputePass, SwapPass)
import repro_torch.core.executor as tensile_executor  # noqa: E402
from repro_torch.core.graph_capture import graph_layout  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       TokenStream, to_device)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kv_block_copy as kbc  # noqa: E402
from repro_torch.kernels import offload_quant as oq  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.build import (build_all, nvcc_path,  # noqa: E402
                                      ptxas_usage)
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     kv_block_gather_ref,
                                     dequantize_blocked_ref,
                                     kv_block_scatter_ref,
                                     quantize_blocked_ref,
                                     ssd_intra_chunk_ref)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import (init_world, make_host_mesh,  # noqa: E402
                                     make_mesh)
from repro_torch.launch.sharding import (HostShard,  # noqa: E402
                                         MeshRules, Sharding, shard_params)
from repro_torch.launch.steps import (TrainStepConfig,  # noqa: E402
                                     build_functional_train_step,
                                     build_prefill_step, build_serve_step,
                                     build_train_step, offloaded_bytes,
                                     opt_state_for, opt_state_shardings,
                                     opt_state_to_host)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import attention_block  # noqa: E402
from repro_torch.models.layers import embed_tokens, rmsnorm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.ssm import mamba2_block  # noqa: E402
from repro_torch.models import whisper as whisper_mod  # noqa: E402
from repro_torch.obs import (DMA_TID, DriftMonitor, EventLog,  # noqa: E402
                             MetricsRegistry, TraceRecorder,
                             parse_metrics_text, summarize_trace,
                             validate_chrome_trace)
from repro_torch.optim.adam import adamw_init  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    compressed_psum_mean, ef_compress_grads, quantize_dequantize)
from repro_torch.runtime.elastic import reshard_state  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FTConfig, resilient_train_loop)
from repro_torch.service import (JobRecord, JobSpec,  # noqa: E402
                                 JobState, JobStore, SchedulerDaemon,
                                 ServeParams, ServiceClient)
from repro_torch.service.workloads import (  # noqa: E402
    make_mlp, mlp_numpy, register_serve_workload, register_workload,
    resolve_workload)
import repro_torch.serving.engine as serving_engine  # noqa: E402
from repro_torch.serving import ServingEngine, make_trace  # noqa: E402
from repro_torch.serving.session import SeqState  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same sheet
FP32_FLOPS_PER_S = 67e12       # fp32 outside the tensor cores, same sheet
TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor-core peak, same sheet
ARCH = "tinyllama-1.1b"
SSM_ARCH = "mamba2-780m"
MAX_SEQUENCES, PROMPT_LEN, GEN_LEN, N_REQUESTS = 4, 16, 16, 8
MAX_LEN = PROMPT_LEN + GEN_LEN
PREFILL_B, PREFILL_S = 4, 2048          # the model's published context
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 4
SOURCE = "src/repro_torch/csrc/kv_block_copy.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
QUANT_SOURCE = "src/repro_torch/csrc/offload_quant.cu"
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
REPLACES = {"kv_block_gather": "src/repro/kernels/kv_block_copy.py:34",
            "kv_block_scatter": "src/repro/kernels/kv_block_copy.py:58",
            "flash_attention_fwd": "src/repro/kernels/flash_attention.py:77",
            "quantize_blocked": "src/repro/kernels/offload_quant.py:43",
            "dequantize_blocked": "src/repro/kernels/offload_quant.py:60",
            "ssd_intra_chunk_fwd": "src/repro/kernels/ssd_scan.py:47"}
# quantize/dequantize sweep: ragged lengths (one element, a row less one, a
# row and one, the reference's (37, 129)) in each input dtype, and 64 MiB
QUANT_SHAPES = [(1,), (511,), (513,), (37, 129)]
QUANT_BIG = (16 << 20,)
# a byte the packed buffer is filled with before a quantize writes it
QUANT_SENTINEL = 0x5A
# CTA counts of the host routes' cap sweep (132: one CTA per SM)
QUANT_CTA_SWEEP = (4, 8, 16, 32, 64, 132)
# fp32 lengths of the swap-in route ladder: packed buffers of 33 KB to
# 16.9 MB
QUANT_LADDER = tuple(1 << k for k in range(15, 25))
# device events counted in the profiled compressed TENSILE step: the
# copies of plain swaps, and the quantize and dequantize kernels
PROFILED_SWAP_NAMES = ("Memcpy DtoH", "Memcpy HtoD", "::quantize_rows",
                       "dequantize_rows")
# the quickstart (examples/quickstart.py): its MLP, batch, planning profile
# and the capture-time cost model the reference uses by default
MLP_SIZES, MLP_BATCH = [256, 1024, 1024, 1024, 16], 64
QUICKSTART_PROFILE = MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                                    mem_bw=1e10)
QUICKSTART_CALIB = DeviceCalibration(flops=5e10, mem_bw=1e10)
# the full-width TENSILE train step: the compressed plan is first planned
# against this fraction of the unscheduled planned peak, which it cannot
# reach; the budget is then the peak it reaches, the tightest it can hold
TENSILE_ITERS = 2
FLOOR_FRACTION = 0.5
# the compressed plan's pipeline: the three passes of
# ``tensile+compressed-offload`` with the compressed pass first.  In the
# named order the plain swap pass books the whole host link at this width
# (mostly optimizer state), and the compressed pass after it finds no
# channel time (PERF.md).  It plans within the iteration: across it, the
# plan compressed parameters and moments too and held no recompute
# (PERF.md); the ``tensile`` plan carries the across-iteration events
COMPRESSED_FIRST = "compressed-first"
# no early stop on stagnation: hundreds of small compressed swaps each move
# the peak by less than the stop's 0.05 % before the other passes run
PLAN_PATIENCE = SchedulerConfig().max_iterations
# the card's allocator peak against the executor's ledger peak
ALLOC_LEDGER_TOL = 0.05
# multi_job: two train jobs of the train step above (batch, iterations,
# seed) and a serve job of the serve phase's shape under one controller.
# Each job's slice of the capacity, with all three live: the train jobs'
# over their unscheduled planned peaks (the top of 0.75-0.85: the
# autoscale pipeline's two-job plans stopped at 0.81-0.84 of the planned
# peak when planned on a CPU with latencies scaled to the card's measured
# ones), the serve job's over its KV demand (two of its four sequences).
# Each train iteration under the controller ends in a replan of 10-80 s
# (PERF.md): A runs 2 iterations (3 until the experience phases needed the
# time) and B 2, so B's first boundary falls while A runs and its second
# iteration starts from the state it parked on the host
MULTI_JOBS = {"A": (TRAIN_B, 2, 0), "B": (2, 2, 1)}
# ... at full width and this many of TinyLlama's 22 layers (22, then 11,
# before the script's time limit held the training launcher's and the
# service phases too; on a slow host the whole ran 1,388 s at 11; the
# controller's replans grow with the operator count; the experience
# phases keep 22, where their warm boot is gated)
CONTROLLER_LAYERS = 4
# tensile_train's step at full width and this many of the 22 layers (all
# 22 until the MoE phase joined the script; at 4 its compressed plan at
# the tightest budget needs no recompute, which the phase gates)
TENSILE_LAYERS = 11
# train_launcher's own steps at full width and this many of the 22 layers
# (TENSILE_LAYERS before the service phase joined, for the time limit as
# above); ``launch.train.main`` runs at its reduced width
LAUNCHER_LAYERS = 4
MULTI_SLICE = 0.85
MULTI_SERVE_SLICE = 0.5
MULTI_PIPELINE = "tensile+autoscale"
TRAIN_WORKLOAD, SERVE_WORKLOAD = "tinyllama-train", "tinyllama-serve"
# hot_swap_full_width: the requested plan's slice of the planned peak
HOT_SWAP_SLICE = 0.8
# experience_cold / experience_warm: job A (the train step above) and job B
# (B 2) as (batch, iterations, seed).  Each runs alone under a controller
# of its own at EXPERIENCE_SLICE of the planned peak of its capture, planned
# from the capture's cost-model latencies with no solo run first: the cold
# start is what is measured
EXPERIENCE_JOBS = {"A": (TRAIN_B, 2, 0), "B": (2, 1, 1)}
EXPERIENCE_SLICE = MULTI_SLICE
# the drift monitor's default threshold (obs/drift.py)
DRIFT_THRESHOLD = 0.15
# service: the scheduler daemon, in the experience_warm process, over the
# store the experience phases wrote.  Job A (experience_cold's A) runs this
# many iterations; job C, the train step at this batch, is a job the store
# does not know; the daemon's poll interval; the gauges its metrics.prom
# must carry (the reference's core set and the serve rate)
SERVICE_A_ITERS = 1
SERVICE_C_BATCH = 3
SERVICE_POLL = 0.02
SERVICE_GAUGES = ("tensile_queue_depth", "tensile_capacity_bytes",
                  "tensile_reserved_bytes", "tensile_state_transitions_total",
                  "tensile_jobs", "tensile_replan_count",
                  "tensile_serve_tokens_per_sec")
# train_launcher: TENSILE's decisions for the launcher's step at this
# fraction of its capture's planned peak; the restart run's steps, its
# checkpoint period and the step that fails once; the int8 run's steps on
# one batch; the steps of the entry point's own run, and its sequence
# length (its own default: at 1,024 tokens the reduced width's 64-token
# attention chunks make 21,593 operators, which the entry point and the
# budget's capture each take about 55 s to capture on a CPU)
LAUNCHER_BUDGET = 0.7
LAUNCHER_STEPS, LAUNCHER_CKPT_EVERY, LAUNCHER_FAIL_AT = 6, 3, 4
LAUNCHER_INT8_STEPS = 4
LAUNCHER_MAIN_STEPS, LAUNCHER_MAIN_SEQ = 3, 128
# the cold-start predictor's fit on A's measured operators
MLP_FIT = {"steps": 2000, "lr": 3e-3, "train_share": 0.8, "seed": 0}
# A compressed step against the unscheduled (exact) step from the same
# state.  Loss: |diff| / |value|.  Parameters and moments: per leaf, the
# compressed step's update new_c - old against the exact step's new_e -
# old, by direction (cosine) and by size (norm ratio), each as the median
# over the leaves whose exact update is not zero.  The int8 rounding of
# activations read again in the forward moves the first step's gradient
# by most of its norm through 22 random layers (||diff|| / ||exact||
# medians 0.73, 0.84, 0.91 for parameters, mu and nu on the H100;
# PERF.md), so the gate is on what such noise keeps and a fault loses: a
# skipped update reads cosine 0 and ratio 0, a sign-flipped one cosine -1,
# an update applied twice ratio 2.  The script checks that the skipped
# update fails.
COMPRESSED_TOL = {"loss": 5e-3, "cosine": 0.2, "ratio": (0.5, 2.0)}
# (B, Sq, Skv, H, KV, D, causal, dtype, window): the reference's sweep,
# tests/test_kernels.py:19-48, and a bf16 twin of each fp32 shape, so every
# padded head dim of the tensor-core path runs (D 112 as 128); the window
# case wipes rows whose first visited kv tile is wholly masked
FLASH_SWEEP = [
    (2, 128, 128, 4, 2, 64, True, torch.float32, 0),
    (1, 200, 200, 8, 1, 32, True, torch.float32, 0),
    (2, 64, 256, 4, 4, 128, False, torch.float32, 0),
    (1, 384, 384, 6, 2, 112, True, torch.float32, 0),
    (2, 256, 256, 4, 2, 64, True, torch.bfloat16, 0),
    (1, 96, 96, 2, 2, 256, True, torch.float32, 0),
    (1, 256, 256, 4, 2, 64, True, torch.float32, 64),
    (2, 128, 128, 4, 2, 64, True, torch.bfloat16, 0),
    (1, 200, 200, 8, 1, 32, True, torch.bfloat16, 0),
    (2, 64, 256, 4, 4, 128, False, torch.bfloat16, 0),
    (1, 384, 384, 6, 2, 112, True, torch.bfloat16, 0),
    (1, 96, 96, 2, 2, 256, True, torch.bfloat16, 0),
    (1, 256, 256, 4, 2, 64, True, torch.bfloat16, 64),
]
# the prefill's attention: TinyLlama's 32 query and 4 kv heads of dim 64
FLASH_PREFILL = (PREFILL_B, PREFILL_S, PREFILL_S, 32, 4, 64, True,
                 torch.bfloat16, 0)
# a D 128 shape timed beside its own SDPA call, a record for the D 128
# configs (qwen2.5-14b, minitron-4b), not a gate
FLASH_D128 = (PREFILL_B, PREFILL_S, PREFILL_S, 32, 8, 128, True,
              torch.bfloat16, 0)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Flash vs plain (attend_full) prefill, as max |diff| / max |reference|;
# PERF.md gives the measurements behind each.  bf16 end to end: 22 layers
# of random weights amplify one-ulp differences of the attention output.
# bf16 per layer, both paths on the same hidden state: a few bf16 ulps
# (2^-8 of a value each).  fp32 end to end: summation order only.
PREFILL_REL_TOL = {"bf16": 0.5, "bf16_layer": 0.02, "fp32": 1e-3}
# (B, NC, Q, H, P, N, x dtype): the reference's sweep (tests/test_kernels.py:
# 51-55) and a ragged chunk, in fp32 (the CUDA-core kernel) and bf16 (the
# tensor-core kernel), and Mamba-2 780M's prefill (B 4 x S 2048 in chunks
# of 256; 48 heads of 64, state 128) with bf16 x as the path gives it; then
# the kernels' edges: Q 1 and 255, P padded (40 to 64) and at 128, rows
# that are not 16-byte multiples (P 20 in bf16, N 18: plain-load staging),
# heads in two ragged groups (13: 7 and 6), and N over one pass of the state
SSD_SWEEP = [(2, 3, 64, 4, 16, 32, torch.float32),
             (1, 2, 128, 2, 64, 128, torch.float32),
             (1, 5, 32, 8, 64, 16, torch.float32),
             (1, 1, 200, 4, 64, 128, torch.float32),
             (2, 3, 64, 4, 16, 32, torch.bfloat16),
             (1, 2, 128, 2, 64, 128, torch.bfloat16),
             (1, 5, 32, 8, 64, 16, torch.bfloat16),
             (1, 1, 200, 4, 64, 128, torch.bfloat16),
             (1, 1, 1, 4, 64, 128, torch.bfloat16),
             (1, 2, 255, 6, 64, 128, torch.bfloat16),
             (1, 2, 255, 6, 64, 128, torch.float32),
             (1, 2, 96, 3, 40, 64, torch.bfloat16),
             (1, 1, 256, 4, 128, 64, torch.bfloat16),
             (1, 1, 192, 2, 128, 200, torch.bfloat16),
             (1, 1, 130, 2, 20, 18, torch.bfloat16),
             (1, 1, 130, 2, 20, 18, torch.float32),
             (1, 1, 128, 13, 32, 32, torch.bfloat16),
             (1, 1, 64, 2, 64, 160, torch.bfloat16)]
SSD_PREFILL = (PREFILL_B, PREFILL_S // 256, 256, 48, 64, 128, torch.bfloat16)
SSD_TOL = 1e-4                 # rtol = atol, tests/test_kernels.py:66-68
# Kernel vs plain chunked SSD prefill of Mamba-2 780M, as max |diff| / max
# |reference|; PERF.md section 2 gives the measurements behind each.  The
# limits were set from the kernel's own 1e-4 when the CUDA-core kernel read
# 0 on all three (both paths rounded alike): in fp32 end to end, that 1e-4;
# per bf16 layer, two bf16 ulps of the largest value (a 1e-4 error in y
# flips at most one ulp of the mixer's output, and the layer's output
# rounds once more); end to end in bf16, the flash limit, since flipped
# ulps grow through the random layers.  The bf16 kernel now sums on the
# tensor cores (3xTF32) and the H100 reads 0.4773 end to end and 0.00578
# per layer, 95 % and 74 % of the limits; fp32 x keeps the plain path's
# order and reads 0.  No control reading shows that the two bf16 gates fail
# a kernel of lower precision: check_ssd's 1e-4 is the check that does
SSM_PREFILL_REL_TOL = {"bf16": 0.5, "bf16_layer": 2.0 ** -7, "fp32": SSD_TOL}
# (shape, dtype, slot axis) of the slotted cache leaves of each model at
# the serve's 4 slots and MAX_LEN positions, in the engine's (sorted) order
TINYLLAMA_LEAVES = [((22, MAX_SEQUENCES, MAX_LEN, 4, 64), torch.bfloat16, 1)
                    ] * 2
MAMBA_LEAVES = [((48, MAX_SEQUENCES, 3, 128), torch.bfloat16, 1),
                ((48, MAX_SEQUENCES, 3, 128), torch.bfloat16, 1),
                ((48, MAX_SEQUENCES, 3, 3072), torch.bfloat16, 1),
                ((48, MAX_SEQUENCES, 48, 64, 128), torch.float32, 1)]
# leaves whose segments are not 16-byte multiples, in one call
ODD_LEAVES = [((3, 5, 7, 11), torch.bfloat16, 1),
              ((2, 5, 33333), torch.bfloat16, 1),
              ((6, 77), torch.uint8, 0),
              ((4, 9, 13), torch.float32, 2)]
# the budgeted Mamba-2 serve's allocator peak over the golden run's: the
# gathered fp32 state rows of one batched transfer (2 slots) and this many
# bytes more, below a copy of a whole cache leaf (4 slots); at all 48
# layers (rows of 75.5 MB) the limit is 160,000,000 B
SSM_SWAP_SLACK = 160_000_000 - 2 * 48 * 48 * 64 * 128 * 4
# the MoE phase (``moe``, a fresh process): Moonlight-16B-A3B at full width,
# served and prefilled at SERVE_LAYERS of its 48 layers and trained at
# MOE_TRAIN_LAYERS (parameters, gradients and fp32 moments of all 48 need
# more than 330 GB), its train step captured and run under a ``tensile``
# plan at MOE_BUDGET of its planned peak; Kimi-K2 at full width and
# KIMI_LAYERS of its 61 (the dense prefix layer and one MoE layer with a
# shared expert); and the reduced card-vs-CPU checks of MOE_SMALL_ARCHS
MOE_ARCH, KIMI_ARCH = "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"
MOE_SMALL_ARCHS = (MOE_ARCH, KIMI_ARCH, "jamba-1.5-large-398b")
MOE_TRAIN_LAYERS, KIMI_LAYERS = 4, 2
# Moonlight's and Mamba-2's serving engines (their serve pair, decode
# profile, batched-restore profile, prefill and Mamba-2's train steps) at
# full width and this many of their 48 layers: at 48 the script ran 1,365 s
# on a slow host, past its 1,200 s limit; TinyLlama serves at all 22
SERVE_LAYERS = {MOE_ARCH: 8, SSM_ARCH: 8}
MOE_BUDGET = 0.7
# Moonlight's prefill is gated per layer in bf16 and end to end in fp32 at
# MOE_TRAIN_LAYERS layers: a bf16 rounding that flips one expert choice
# changes that token's whole FFN output, so no end-to-end bf16 bound over
# many routed layers says anything about the kernel (it is printed)
MOE_PREFILL_REL_TOL = {"bf16_layer": PREFILL_REL_TOL["bf16_layer"]}
# the attention of Moonlight's prefill (16 heads of 128, MHA) and of
# Kimi-K2's (B 1 x S 2048, 64 query and 8 kv heads of 112, which the
# tensor-core path pads to 128)
FLASH_MOONLIGHT = (PREFILL_B, PREFILL_S, PREFILL_S, 16, 16, 128, True,
                   torch.bfloat16, 0)
FLASH_KIMI = (1, PREFILL_S, PREFILL_S, 64, 8, 112, True, torch.bfloat16, 0)
# Moonlight's two slotted cache leaves (k, v) at the serve's shape
MOONLIGHT_LEAVES = [((48, MAX_SEQUENCES, MAX_LEN, 16, 128), torch.bfloat16,
                     1)] * 2
# the whisper phase (``whisper``, a fresh process): whisper-base at full
# width and depth (6 encoder and 6 decoder layers, d 512, 8 heads of 64,
# vocab 51968 padded) on 30-s windows: 3000 mel frames, which the stubbed
# conv frontend's stride 2 makes 1500 encoder frames, and 1500 / 4 = 375
# decoder tokens by the reference's enc_seq_ratio; B 16 windows.  Decode
# runs WHISPER_DECODE_STEPS greedy steps against a cache of Whisper's text
# context (448); train WHISPER_TRAIN_STEPS steps with block remat; the
# functional step without remat under ``tensile`` at WHISPER_BUDGET of its
# planned peak.  The reduced card-vs-CPU checks run WHISPER_SMALL_S frames,
# over 2 * attn_chunk (64), so the encoder and the cross-attention take
# ``attend_chunked``
WHISPER_ARCH = "whisper-base"
WHISPER_B, WHISPER_S = 16, 1500
WHISPER_MAX_LEN = 448
WHISPER_DECODE_STEPS = 32
WHISPER_TRAIN_STEPS = 4
WHISPER_BUDGET = 0.7
WHISPER_SMALL_S = 160
# the decode steps' fp32 logits against the forward over the same tokens
# (tests/test_models.py:108-125, as tests/test_torch_forward.py holds it)
DECODE_FORWARD_TOL = 2e-3
# the decoder's causal self-attention at whisper's prefill: 375 is no
# multiple of a tile, so the kernel's ragged edges run at full width
FLASH_WHISPER = (WHISPER_B, WHISPER_S // 4, WHISPER_S // 4, 8, 8, 64, True,
                 torch.bfloat16, 0)
FLASH_WHISPER_FP32 = FLASH_WHISPER[:7] + (torch.float32, 0)
# the device kernels each prefill kernel's wrapper launches, by name
KERNEL_NAMES = {fa.flash_attention_fwd: ("flash_fwd",),
                ss.ssd_intra_chunk_fwd: ("ssd_fwd",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def events_turns(fns, reps: int, inner: int = 1) -> list:
    """For each of ``fns``, the median over ``reps`` of CUDA-event time of
    ``inner`` back-to-back calls, per call, after warm-up.  The functions
    are timed in turns (a b, b a, a b, ...), so that a drift of the host's
    speed reaches all alike."""
    for _ in range(3):
        for f in fns:
            f()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fns[i]()
            b.record()
            b.synchronize()
            times[i].append(a.elapsed_time(b) / inner)
    return [statistics.median(t) for t in times]


def events_ms(fn, reps: int, inner: int = 1) -> float:
    """``events_turns`` of ``fn`` alone."""
    return events_turns([fn], reps, inner)[0]


@contextlib.contextmanager
def without_determinism():
    """Deterministic algorithms off: ``torch.empty`` on the card then
    queues no NaN fill, and ``index_copy_`` runs (it has no deterministic
    CUDA path).  For the KV timings and profiles (as a server runs) and
    the plain scatter."""
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det)


def device_ms(fn, reps: int = 20, per_call: int = 1,
              traces: int = 5) -> float:
    """Mean device time per call of ``fn``, which issues ``per_call``
    kernels and copies: their time summed from a ``torch.profiler`` trace
    of ``reps`` calls, over ``reps``.  Only a trace that holds every one
    of the ``reps * per_call`` events counts: after the first serve,
    traces inside this script lose the earliest events of a window
    (PERF.md section 7), so device times are taken before it, or in a
    fresh process (``quant_device_ms``), where a trace has lost events
    too, more rarely.  A trace that lost events is taken again, up to
    ``traces`` in all; raises if none holds them all."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(events) == reps * per_call:
            return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
        seen.append(len(events))
    raise AssertionError(f"the profiler traces hold {seen} device events, "
                         f"not {reps * per_call}")


def wall_s(fn, reps: int) -> float:
    """Median host-clock seconds of ``fn`` ending in a synchronise."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build() -> dict:
    t0 = time.perf_counter()
    built = build_all()
    log(f"[build] {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for b in built.values():
        for line in b.log.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Performance Loss")):
                log(f"[build] {b.name}: {line.strip()}")
    return built


def measure_host_link() -> dict:
    """Pinned host <-> device copies: rate at 256 MiB, latency of a
    512-byte copy (host clock, ending in a synchronise), and the added cost
    of each further small copy queued behind one synchronise."""
    dev = torch.device("cuda")
    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(n, dtype=torch.uint8, device=dev)
    h2d = n / (events_ms(lambda: card.copy_(host, non_blocking=True), 5)
               * 1e-3)
    d2h = n / (events_ms(lambda: host.copy_(card, non_blocking=True), 5)
               * 1e-3)
    small_h = torch.empty(512, dtype=torch.uint8, pin_memory=True)
    small_d = torch.empty(512, dtype=torch.uint8, device=dev)
    lat_d2h = wall_s(lambda: small_h.copy_(small_d), 200)
    lat_h2d = wall_s(lambda: small_d.copy_(small_h), 200)
    members = 8
    hosts = [torch.empty(512, dtype=torch.uint8, pin_memory=True)
             for _ in range(members)]

    def queued():
        for h in hosts:
            h.copy_(small_d, non_blocking=True)

    def one():
        hosts[0].copy_(small_d, non_blocking=True)

    per_member = (wall_s(queued, 200) - wall_s(one, 200)) / (members - 1)
    del host, card
    return {"h2d_bytes_per_s": h2d, "d2h_bytes_per_s": d2h,
            "host_link_bw": min(h2d, d2h),
            "latency_h2d_s": lat_h2d, "latency_d2h_s": lat_d2h,
            "host_link_latency": max(lat_h2d, lat_d2h),
            "dma_batch_overhead": max(per_member, 0.0)}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_kernels(shapes) -> float:
    """Bit-exact kernel vs plain version for every (N, W, dtype, K) in
    ``shapes``, including the rows a scatter must leave alone.  Returns
    the largest absolute difference seen (0.0 when all pass)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for n, w, dtype, k in shapes:
        pool = (torch.randn((n, w), generator=gen, device="cuda") * 100
                ).to(dtype)
        idx = torch.randperm(n, generator=gen, device="cuda")[:k].tolist()
        got = kbc.kv_block_gather(pool, idx)
        want = kv_block_gather_ref(pool, idx)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"gather differs at {(n, w, dtype, k)}")
        blocks = (torch.randn((k, w), generator=gen, device="cuda") * 100
                  ).to(dtype)
        mine = kbc.kv_block_scatter(pool.clone(), idx, blocks)
        plain = kv_block_scatter_ref(pool.clone(), idx, blocks)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(mine, plain))
        untouched = [i for i in range(n) if i not in idx]
        if not (torch.equal(mine, plain)
                and torch.equal(mine[untouched], pool[untouched])):
            raise AssertionError(f"scatter differs at {(n, w, dtype, k)}")
        back = kbc.kv_block_scatter(pool.clone(), idx,
                                    kbc.kv_block_gather(pool, idx))
        if not torch.equal(back, pool):
            raise AssertionError(f"round trip differs at {(n, w, dtype, k)}")
        log(f"[kernels] bit-exact: pool ({n}, {w}) {dtype} K={k}")
    return worst


def random_leaves(spec, gen, offset: int = 0) -> list:
    """Card tensors of ``spec``'s (shape, dtype, axis) of random bytes (NaN
    payloads included), each base ``offset`` elements past its
    allocation's."""
    out = []
    for shape, dtype, _ in spec:
        item = torch.empty((), dtype=dtype).element_size()
        n = (math.prod(shape) + offset) * item
        raw = torch.randint(0, 256, (n,), generator=gen, device="cuda",
                            dtype=torch.uint8)
        out.append(raw.view(dtype)[offset:].view(shape))
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def check_leaves(cases) -> float:
    """One gather and one scatter call over every leaf of each case (a
    leaf spec, K, base offset in elements), read and written in place,
    byte for byte against the plain versions (``index_select`` and
    ``index_copy_`` along the slot axis); every other slot untouched; one
    launch a call.  Returns the largest absolute difference (0.0 when all
    pass)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for spec, k, offset in cases:
        leaves = random_leaves(spec, gen, offset)
        axes = [a for _, _, a in spec]
        n = min(shape[a] for shape, _, a in spec)
        idx = torch.randperm(n, generator=gen, device="cuda")[:k].tolist()
        want = kv_block_gather_ref(leaves, idx, axis=axes)
        blocks = [random_leaves([(w.shape, w.dtype, 0)], gen)[0]
                  for w in want]
        with without_determinism():
            plain = kv_block_scatter_ref([x.clone() for x in leaves], idx,
                                         blocks, axis=axes)
        g0 = kbc.kv_block_gather.launches
        s0 = kbc.kv_block_scatter.launches
        got = kbc.kv_block_gather(leaves, idx, axis=axes)
        mine = [x.clone() for x in leaves]
        ptrs = [x.data_ptr() for x in mine]
        kbc.kv_block_scatter(mine, idx, blocks, axis=axes)
        torch.cuda.synchronize()
        what = f"{[tuple(sh) for sh, _, _ in spec]} K={k} offset {offset}"
        for g, w in zip(got, want):
            if g.dtype.is_floating_point:
                worst = max(worst, max_abs_err(g.nan_to_num(),
                                               w.nan_to_num()))
            if not same_bits(g, w):
                raise AssertionError(f"gather differs at {what}")
        if not all(same_bits(m, q) for m, q in zip(mine, plain)):
            raise AssertionError(f"scatter differs at {what}")
        if [x.data_ptr() for x in mine] != ptrs:
            raise AssertionError(f"scatter moved a leaf at {what}")
        if (kbc.kv_block_gather.launches - g0,
                kbc.kv_block_scatter.launches - s0) != (1, 1):
            raise AssertionError(f"not one launch a call at {what}")
        log(f"[kernels] bit-exact: {len(spec)} leaves {what}")
    return worst


def time_leaves(spec, k: int) -> dict:
    """Times of one gather and one scatter call over every leaf of
    ``spec`` at K slots, deterministic algorithms off (as a server runs:
    no NaN fill of the gathered rows): ``ms`` the wrapper as the engine
    calls it, from host ints (median CUDA-event time of back-to-back
    calls, per call); ``library_ms`` one ``index_select``
    (``index_copy_``) call per leaf along its slot axis with prepared
    int64 device indices, all the leaves' calls back to back, timed in
    turns with ``ms``; ``device_ms`` and ``library_device_ms`` from
    profiler traces; the plain versions; and the bound: every gathered
    byte read once and written once at 3.35 TB/s."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = random_leaves(spec, gen)
    axes = [a for _, _, a in spec]
    n = min(shape[a] for shape, _, a in spec)
    rows = torch.randperm(n, generator=gen, device="cuda")[:k].tolist()
    idx64 = torch.tensor(rows, dtype=torch.long, device="cuda")
    blocks = kv_block_gather_ref(leaves, rows, axis=axes)
    moved = sum(b.numel() * b.element_size() for b in blocks)
    big = moved > (8 << 20)
    reps, inner = (10, 3) if big else (20, 50)
    res = {"leaves": [[list(sh), str(dt).replace("torch.", ""), a]
                      for sh, dt, a in spec], "k": k, "bytes": 2 * moved,
           "bound_ms": 2 * moved / HBM_BYTES_PER_S * 1e3}
    with without_determinism():
        srcs = [torch.index_select(x, a, idx64) for x, a in zip(leaves, axes)]

        def lib_gather():
            for x, a in zip(leaves, axes):
                torch.index_select(x, a, idx64)

        def lib_scatter():
            for x, a, src in zip(leaves, axes, srcs):
                x.index_copy_(a, idx64, src)

        calls = {
            "kv_block_gather": (
                lambda: kbc.kv_block_gather(leaves, rows, axis=axes),
                lambda: kv_block_gather_ref(leaves, rows, axis=axes),
                lib_gather),
            "kv_block_scatter": (
                lambda: kbc.kv_block_scatter(leaves, rows, blocks,
                                             axis=axes),
                lambda: kv_block_scatter_ref(leaves, rows, blocks,
                                             axis=axes),
                lib_scatter)}
        for name, (wrapper, plain, lib) in calls.items():
            ms, lib_ms = events_turns([wrapper, lib], reps, inner)
            res[name] = {
                "ms": ms, "library_ms": lib_ms,
                "device_ms": device_ms(wrapper),
                "plain_ms": events_ms(plain, reps, max(inner // 5, 1)),
                "library_device_ms": device_ms(lib, per_call=len(spec))}
    return res


def decode_steps(cfg, params, device: str) -> tuple:
    """6 decode steps of ``cfg`` on ``params`` from an empty cache (B 2,
    tokens from a CPU generator seeded 1): each step's logits on the host
    and its MoE routes (``recording_routes``)."""
    api = get_model(cfg, device)
    cache = api.init_cache(2, 8)
    tok = torch.Generator().manual_seed(1)
    logits, routes = [], []
    for i in range(6):
        t = torch.randint(0, cfg.vocab_size, (2, 1), generator=tok)
        with torch.inference_mode(), recording_routes() as r:
            lg, _ = api.decode(params, {"tokens": t.to(device)}, cache, i)
        logits.append(lg.cpu())
        routes.append(r)
    return logits, routes


def tolerance_share(got: torch.Tensor, want: torch.Tensor,
                    tol: float) -> float:
    """max |got - want| / (tol + tol |want|): at most 1 within ``allclose``
    at rtol = atol = ``tol``."""
    return float(((got.double() - want.double()).abs()
                  / (tol + tol * want.double().abs())).max())


def widened(params, cfg, dtype: str = "float64"):
    """``params`` in ``dtype`` on the same device, and ``cfg`` in it."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    wide = get_model(cfg, "cpu").shell()
    wide.load_state_dict({k: v.to(getattr(torch, dtype)) for k, v
                          in params.state_dict().items()}, assign=True)
    return wide, cfg


def check_decode_on_small_input(arch: str = ARCH) -> None:
    """Reduced ``arch``: the card's decode steps agree with the CPU's on
    the same weights, tokens and cache (atol = rtol = 1e-4, the port's CPU
    parity tolerance; matmuls run in full fp32, TF32 is off), each MoE
    layer's expert choices first, exactly.  The steps run in fp32 unless
    the CPU's own fp32 steps lie further than half the tolerance from the
    same steps in float64 (``own_share`` over 0.5): two fp32 runs may then
    differ by rounding alone by more than the tolerance, and both devices
    run in float64 (no kernel lies on the decode path).  Reduced Jamba's
    MoE layers, drawn at the reference's fan-in (the expert count), lift
    its residual stream to about 1,000."""
    cfg = get_config(arch).reduced()
    cpu, card = small_models(cfg)
    want, r_cpu = decode_steps(cfg, cpu, "cpu")
    wide, cfg64 = widened(cpu, cfg)
    exact, r_exact = decode_steps(cfg64, wide, "cpu")
    own = max(tolerance_share(w, e, 1e-4) for w, e in zip(want, exact))
    if own > 0.5:
        cpu, (card, cfg), want, r_cpu = wide, widened(card, cfg), exact, \
            r_exact
    got, r_card = decode_steps(cfg, card, "cuda")
    for i, (lg, lc) in enumerate(zip(got, want)):
        compare_routes(r_cpu[i], r_card[i], f"reduced {arch} decode step "
                       f"{i}")
        if not torch.allclose(lg, lc, atol=1e-4, rtol=1e-4):
            raise AssertionError(
                f"decode step {i}: card and CPU differ by "
                f"{max_abs_err(lg, lc)}")
    log(f"[check] reduced {cfg.dtype} {arch} decode: card == CPU within "
        f"1e-4 over 6 steps (the CPU's fp32 steps against float64: "
        f"{own:.3f} of the tolerance)")


def small_models(cfg):
    """Reduced weights from seed 0 on the CPU, and the same values on the
    card."""
    api = get_model(cfg, "cpu")
    cpu = api.init(torch.Generator().manual_seed(0))
    card = api.shell()
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    return cpu, card


def serve(profile: MachineProfile, arch: str = ARCH) -> dict:
    t0 = time.perf_counter()
    eng = ServingEngine(arch, reduced=False, max_sequences=MAX_SEQUENCES,
                        max_len=MAX_LEN, seed=0, device="cuda",
                        n_layers=SERVE_LAYERS.get(arch))
    torch.cuda.synchronize()
    n_params = sum(p.numel() * p.element_size()
                   for p in eng.params.parameters())
    log(f"[serve] {eng.cfg.name} {eng.cfg.dtype}: {eng.cfg.n_layers} layers,"
        f" d {eng.cfg.d_model}, params {n_params} B, bytes_per_token "
        f"{eng.bytes_per_token}, init {time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        logits, _ = eng.api.decode(
            eng.params, {"tokens": torch.zeros((1, 1), dtype=torch.int32,
                                               device="cuda")},
            eng.api.init_cache(1, MAX_LEN), 0)
    if logits.shape != (1, 1, eng.cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")

    step_ms = []
    plain_step = eng._step

    def timed_step(params, cache, batch, index):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_step(params, cache, batch, index)
        torch.cuda.synchronize()
        if batch["tokens"].shape[0] == MAX_SEQUENCES:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng._step = timed_step
    reqs = make_trace("poisson", N_REQUESTS, seed=0, prompt_len=PROMPT_LEN,
                      gen_len=GEN_LEN)

    runs = {}
    # the KV launches of each batched save and restore, by the wrappers'
    # counts: (method, gather launches, scatter launches) -> calls
    transfers = collections.Counter()

    def counting(method):
        fn = getattr(eng, method)

        def call(states):
            g0 = kbc.kv_block_gather.launches
            s0 = kbc.kv_block_scatter.launches
            out = fn(states)
            transfers[(method, kbc.kv_block_gather.launches - g0,
                       kbc.kv_block_scatter.launches - s0)] += 1
            return out
        return call

    for name in ("golden", "budgeted"):
        step_ms.clear()
        budget = (None if name == "golden"
                  else eng.bytes_per_token * (2 * MAX_LEN + 2))
        mem = MemoryEngine(profile=profile, capacity_bytes=budget,
                           trace=True)
        shapes = collections.Counter()
        moved = []
        if name == "budgeted":
            # the main path: counts from 0, calls recorded as it makes them
            kbc.kv_block_gather.launches = 0
            kbc.kv_block_scatter.launches = 0
            xfer = eng._xfer
            eng._xfer = lambda fn: moved.append(xfer(fn)) or moved[-1]
            serving_engine.kv_block_gather = _spy(kbc.kv_block_gather,
                                                  "kv_block_gather", shapes)
            serving_engine.kv_block_scatter = _spy(kbc.kv_block_scatter,
                                                   "kv_block_scatter", shapes)
            eng._save_slots = counting("_save_slots")
            eng._restore_slots = counting("_restore_slots")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            rep, out = eng.serve(reqs, budget_bytes=budget,
                                 schedule=name == "budgeted",
                                 block_tokens=4, engine=mem,
                                 batch_transfers=name == "budgeted")
            torch.cuda.synchronize()
        finally:
            serving_engine.kv_block_gather = kbc.kv_block_gather
            serving_engine.kv_block_scatter = kbc.kv_block_scatter
            eng.__dict__.pop("_save_slots", None)
            eng.__dict__.pop("_restore_slots", None)
            eng.__dict__.pop("_xfer", None)
        wall = time.perf_counter() - t
        launches = {"kv_block_gather": kbc.kv_block_gather.launches,
                    "kv_block_scatter": kbc.kv_block_scatter.launches}
        runs[name] = dict(
            report=rep, out=out, wall_s=wall, shapes=shapes,
            launches=launches, budget=budget, moved=moved,
            trace=mem.trace.keys(),
            median_step_ms=statistics.median(step_ms),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"[serve] {name}: budget {budget} B, wall {wall:.3f} s, "
            f"{rep.tokens_generated} tokens, "
            f"{rep.tokens_generated / wall:.1f} tok/s wall, median decode "
            f"step {statistics.median(step_ms):.3f} ms over "
            f"{len(step_ms)} steps, max_memory_allocated "
            f"{runs[name]['max_memory_allocated']} B, served {rep.served}, "
            f"oom_events {rep.oom_events}, evictions {rep.evictions}, "
            f"prefetches {rep.prefetches}, peak {rep.peak_bytes} B, "
            f"turns {rep.turns}, batched_transfers {rep.batched_transfers}")

    gold, bud = runs["golden"], runs["budgeted"]
    if gold["report"].served != N_REQUESTS or any(
            len(t) != GEN_LEN or not all(0 <= x < eng.cfg.vocab_size
                                         for x in t)
            for t in gold["out"].values()):
        raise AssertionError("golden run: wrong number or range of tokens")
    if bud["out"] != gold["out"]:
        raise AssertionError("budgeted tokens differ from the golden run")
    rep = bud["report"]
    if rep.oom_events != 0 or rep.evictions <= 0:
        raise AssertionError(f"budgeted run: oom_events {rep.oom_events}, "
                             f"evictions {rep.evictions}")
    if rep.peak_bytes > bud["budget"]:
        raise AssertionError(f"peak {rep.peak_bytes} > budget "
                             f"{bud['budget']}")
    n_slotted = len(eng._slotted()[1])
    groups = -(-n_slotted // kbc.MAX_LEAVES)
    # a batched save gathers and a batched restore gathers and scatters
    # every slotted leaf, one launch per group of MAX_LEAVES leaves; a
    # transfer of one slot takes the per-slot path and launches nothing
    allowed = {"_save_slots": {(0, 0), (groups, 0)},
               "_restore_slots": {(0, 0), (groups, groups)}}
    bad = [k for k in transfers if k[1:] not in allowed[k[0]]]
    batched = {m: sum(c for k, c in transfers.items()
                      if k[0] == m and k[1]) for m in allowed}
    for name, n in bud["launches"].items():
        calls = sum(c for key, c in bud["shapes"].items() if key[0] == name)
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the serve path")
        if n != calls or any(len(key[1]) > kbc.MAX_LEAVES
                             for key in bud["shapes"]):
            raise AssertionError(f"{name}: {n} launches for {calls} calls "
                                 f"of at most {kbc.MAX_LEAVES} leaves each")
    if bad or not all(batched.values()):
        raise AssertionError(f"batched transfers made {dict(transfers)} "
                             f"(method, gather, scatter) launches: each must "
                             f"make ceil({n_slotted}/{kbc.MAX_LEAVES}) = "
                             f"{groups} per kernel it runs")
    log(f"[serve] budgeted tokens == golden tokens for all {N_REQUESTS} "
        f"requests; launches {bud['launches']} ({groups} per kernel and "
        f"batched transfer, {n_slotted} leaves in all; batched saves and "
        f"restores {batched}); max_memory_allocated over the golden "
        f"run {bud['max_memory_allocated'] - gold['max_memory_allocated']} "
        f"B; calls {dict(bud['shapes'])}")
    eng._step = plain_step
    return {"eng": eng, "runs": runs}


def profile_restore(arch: str) -> dict:
    """One batched restore of slots 0 and 1 over their whole rows, as a
    decode turn makes it, after a batched save made their shadows, in a
    full-width serving engine of ``arch`` made for it: its KV launches (by
    the wrappers' counts: one gather, one scatter), its span on the device
    by CUDA events, and device-busy ms with the kernels and copies by name
    from ``torch.profiler``, which must hold every one of them.  Runs in a
    fresh process (``in_fresh_process``), whose algorithms are not made
    deterministic: as a server runs, no NaN fill of the gathered rows."""
    eng = ServingEngine(arch, reduced=False, max_sequences=MAX_SEQUENCES,
                        max_len=MAX_LEN, seed=0, device="cuda",
                        n_layers=SERVE_LAYERS.get(arch))
    states = [SeqState(rid=f"restore{i}", slot=i, prompt_len=PROMPT_LEN,
                       gen_len=GEN_LEN, priority=1.0, arrival=0.0,
                       pos=MAX_LEN) for i in (0, 1)]
    eng._save_slots(states)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    eng._restore_slots(states)
    end.record()
    end.synchronize()
    span_ms = start.elapsed_time(end)
    eng._save_slots(states)
    torch.cuda.synchronize()
    g0, s0 = kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches
    prof = profile_window(lambda: eng._restore_slots(states),
                          names=("copy_tiles", "Memcpy HtoD", "Memcpy DtoD"),
                          top=12)
    launches = (kbc.kv_block_gather.launches - g0,
                kbc.kv_block_scatter.launches - s0)
    n_slotted = len(eng._slotted()[1])
    groups = -(-n_slotted // kbc.MAX_LEAVES)
    if launches != (groups, groups):
        raise AssertionError(f"a batched restore made {launches} gather and "
                             f"scatter launches, not {groups} each")
    # the gathers, the scatters and one copy per slot and slotted leaf
    expected = 2 * groups + len(states) * n_slotted
    if prof["device_kernels"] != expected \
            or prof["named"]["copy_tiles"][0] != 2 * groups:
        raise AssertionError(f"the restore's profile holds "
                             f"{prof['device_kernels']} device events "
                             f"({prof['named']['copy_tiles'][0]} KV "
                             f"kernels), not {expected} ({2 * groups})")
    out = {"events_span_ms": span_ms, "wall_ms": prof["wall_ms"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_events": prof["device_kernels"],
           "kv_kernels": prof["named"]["copy_tiles"],
           "h2d_copies": prof["named"]["Memcpy HtoD"],
           "d2d_copies": prof["named"]["Memcpy DtoD"],
           "by_name_ms": prof["top_kernels_ms"]}
    log(f"[profile] {eng.cfg.name} batched restore of 2 slots: "
        + json.dumps(out))
    return out


def profile_window(fn, names=(), top: int = 5) -> dict:
    """Device-busy ms, the device's idle share and the ``top`` kernels with
    the most device time over one call of ``fn``, from ``torch.profiler``;
    for each of ``names``, the count and device ms of the kernels whose
    name holds it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    named = {n: [sum(n in e.name for e in kernels),
                 sum(e.time_range.elapsed_us() for e in kernels
                     if n in e.name) / 1e3] for n in names}
    return {"wall_ms": wall_ms, "device_kernels": len(kernels),
            "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if kernels else None,
            "top_kernels_ms": dict(by_name.most_common(top)), "named": named}


def profile_decode(eng, steps: int = 2) -> dict:
    """Device time against host time over a few full-batch decode steps,
    from ``torch.profiler``: kernels per step, device-busy milliseconds and
    the device's idle share of the window."""
    batch = {"tokens": torch.zeros((MAX_SEQUENCES, 1), dtype=torch.int32,
                                   device="cuda")}
    for i in range(2):
        eng._step(eng.params, eng.cache, batch, i)

    def run():
        for i in range(steps):
            eng._step(eng.params, eng.cache, batch, i)

    prof = profile_window(run)
    out = {"steps": steps, "wall_ms_per_step": prof["wall_ms"] / steps,
           "device_kernels_per_step": prof["device_kernels"] / steps,
           "device_busy_ms_per_step": prof["device_busy_ms"] / steps,
           "device_idle_share": prof["device_idle_share"],
           "top_kernels_ms": prof["top_kernels_ms"]}
    log("[profile] decode step (profiled, B=4): " + json.dumps(out))
    return out


def flash_inputs(shape, seed: int):
    b, sq, skv, h, kvh, d, _, dtype, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(dims):
        return torch.randn(dims, generator=gen, device="cuda").to(dtype)

    return draw((b, sq, h, d)), draw((b, skv, kvh, d)), draw((b, skv, kvh, d))


def check_flash(shapes=None) -> dict:
    """The flash kernel against ``flash_attention_ref`` on the card, at
    ``shapes`` (default: the reference's sweep, its bf16 twins and the
    prefill's shape), within the reference's tolerances (2e-5 fp32, 2e-2
    bf16, as ``allclose`` rtol = atol); a second call on the same inputs
    must give the same bits.  Returns the largest absolute difference per
    shape."""
    errs = {}
    for shape in shapes or FLASH_SWEEP + [FLASH_PREFILL]:
        causal, dtype, window = shape[6], shape[7], shape[8]
        q, k, v = flash_inputs(shape, 0)
        with torch.inference_mode():
            got = fa.flash_attention_fwd(q, k, v, causal=causal,
                                         sliding_window=window)
            again = fa.flash_attention_fwd(q, k, v, causal=causal,
                                           sliding_window=window)
            want = flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=window)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        tol = FLASH_TOL[dtype]
        errs[shape] = err
        log(f"[flash] {shape[:6]} causal={causal} {dtype} window={window}: "
            f"max_abs_err {err:.3e} (tol {tol})")
        if got.shape != want.shape or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash kernel differs at {shape}: {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"two flash calls differ at {shape}")
        del q, k, v, got, again, want
    return errs


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs that the masks leave for these lengths."""
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return int(mask.sum())


def time_flash(shape=FLASH_PREFILL, plain: bool = True) -> dict:
    """Times at one attention shape (the prefill's by default): the kernel
    (CUDA events over back-to-back calls of the wrapper; its device time
    comes from the prefill's profile), its plain version, and
    ``scaled_dot_product_attention`` (the library yardstick, on its
    (B,H,S,D) layout with the kv heads expanded, prepared outside the timed
    call; never called by the port).  The bound counts the two products
    over the unmasked pairs at the bf16 peak against q, k, v and o read or
    written once at the HBM rate."""
    b, sq, skv, h, kvh, d, causal, dtype, window = shape
    q, k, v = flash_inputs(shape, 1)
    g = h // kvh
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    flops = 4 * b * h * d * attention_pairs(sq, skv, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        res = {
            "ms": events_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, sliding_window=window), 10, inner=5),
            "library_ms": events_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 10, inner=5),
        }
        if plain:
            res["plain_ms"] = events_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal, sliding_window=window), 5)
    res.update(flops=flops, bytes=nbytes, bound_ms=max(bound_ops,
                                                        bound_bytes),
               bound_by="operations" if bound_ops >= bound_bytes
               else "bytes", ops_bound_ms=bound_ops,
               bytes_bound_ms=bound_bytes)
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    res["library_tflops"] = flops / (res["library_ms"] * 1e-3) / 1e12
    log("[time] flash_attention_fwd " + json.dumps(
        {"shape": [b, sq, h, kvh, d, str(dtype).replace("torch.", ""),
                   "causal" if causal else "full"], **res}))
    del q, k, v, qt, kt, vt
    return res


def kernel_label(mangled: str, kernel: str):
    """``kernel<template arguments>`` of a mangled instantiation of
    ``kernel`` (integer, bool, float or bf16 arguments), or None."""
    m = re.search(rf"({kernel}\w*?)I((?:L[ib]\d+E|13__nv_bfloat16|f)+)E",
                  mangled)
    if not m:
        return None
    args = [a if a else ("bf16" if b else "f32") for a, b in re.findall(
        r"L[ib](\d+)E|(13__nv_bfloat16)|f", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def build_report(built: dict, lib: str, kernel: str,
                 ops=("HGMMA", "HMMA", "UTMALDG")) -> dict:
    """What the library ``lib`` was compiled to: ptxas registers, stack and
    spills of each instantiation of ``kernel``, as name<template arguments>
    (from this run's build log; empty when the library was already built),
    and the count of each of ``ops`` (tensor-core and TMA instructions) in
    its SASS (``cuobjdump``), over the library and per instantiation."""
    ptxas = {}
    for name, use in ptxas_usage(built[lib].log).items():
        label = kernel_label(name, kernel)
        if label:
            ptxas[label] = use
    out = {"ptxas": ptxas, "sass": None}
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(built[lib].path)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        out["sass"] = {op: len(re.findall(rf"\b{op}\.", sass))
                       for op in ops}
        per = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            label = kernel_label(part.split(None, 1)[0], kernel)
            if label:
                per[label] = {op: len(re.findall(rf"\b{op}\.", part))
                              for op in ops}
        out["sass_per_kernel"] = per
    log(f"[build] {lib} " + json.dumps(out))
    return out


def _attention_mix(p, h, pos, cfg):
    return attention_block(p["attn"], h, pos, cfg=cfg)


def _mamba_mix(p, h, pos, cfg):
    return mamba2_block(p["mamba"], h, cfg)


def ssd_inputs(shape, seed: int) -> list:
    """The reference test's draws (tests/test_kernels.py:57-61), from
    numpy: normal x, B and C, softplus-normal dt, minus softplus-normal dA;
    on the card, x in the shape's dtype."""
    b, nc, q, h, p, n, dtype = shape
    rng = np.random.default_rng(seed)

    def softplus(a):
        return np.log1p(np.exp(a)).astype(np.float32)

    arrays = (rng.standard_normal((b, nc, q, h, p), dtype=np.float32),
              softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32)),
              -softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32)),
              rng.standard_normal((b, nc, q, n), dtype=np.float32),
              rng.standard_normal((b, nc, q, n), dtype=np.float32))
    out = [torch.from_numpy(a).cuda() for a in arrays]
    out[0] = out[0].to(dtype)
    return out


def check_ssd() -> dict:
    """The SSD kernels (the tensor-core one for bf16 x, the CUDA-core one
    for fp32 x) against ``ssd_intra_chunk_ref`` on the card at the
    reference's sweep, a ragged chunk, the kernels' edges and the
    prefill's shape, inputs from numpy seed 0, within rtol = atol = SSD_TOL
    on both outputs; a second call on the same inputs must give the same
    bits (no atomics, a fixed order of sums).  Returns per shape the
    largest absolute difference and the largest share of the tolerance,
    |diff| / (atol + rtol |ref|) (at most 1 when it passes)."""
    errs = {}
    for shape in SSD_SWEEP + [SSD_PREFILL]:
        args = ssd_inputs(shape, 0)
        with torch.inference_mode():
            got = ss.ssd_intra_chunk_fwd(*args)
            again = ss.ssd_intra_chunk_fwd(*args)
            want = ssd_intra_chunk_ref(*args)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        share = max(float(((a - b).abs() / (SSD_TOL + SSD_TOL * b.abs()))
                           .max()) for a, b in zip(got, want))
        errs[shape] = {"max_abs_err": err, "tolerance_share": share,
                       "max_abs_ref": max(float(b.abs().max())
                                          for b in want)}
        log(f"[ssd] {shape[:6]} {shape[6]}: max_abs_err {err:.3e}, "
            f"tolerance share {share:.3f}, max |ref| "
            f"{errs[shape]['max_abs_ref']:.1f}")
        if any(a.shape != b.shape or a.dtype != torch.float32
               or not torch.allclose(a, b, rtol=SSD_TOL, atol=SSD_TOL)
               for a, b in zip(got, want)):
            raise AssertionError(f"ssd kernel differs at {shape}: {err}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"two ssd calls differ at {shape}")
        del args, got, again, want
    return errs


def ssd_work(shape) -> dict:
    """FLOP and bytes of the intra-chunk function at ``shape``.  The FLOP
    it needs: C.B^T over the causal pairs j <= i once per (batch, chunk),
    since the heads share B and C (``cb_flops``); the weighted sum over the
    same pairs and the state product per head (``head_flops``).  The
    bytes: each input read and each output written once.  The full square
    is the Q x Q tile per head that the Pallas grid computes."""
    b, nc, q, h, p, n, dtype = shape
    pairs = q * (q + 1) // 2
    cb_flops = 2 * b * nc * pairs * n
    head_flops = 2 * b * nc * h * (pairs * p + q * n * p)
    square = 2 * b * nc * (q * q * n + h * (q * q * p + q * n * p))
    x_bytes = 2 if dtype == torch.bfloat16 else 4
    nbytes = (b * nc * q * h * p * (x_bytes + 4) + 2 * b * nc * q * h * 4
              + 2 * b * nc * q * n * 4 + b * nc * h * p * n * 4)
    return {"flops": cb_flops + head_flops, "cb_flops": cb_flops,
            "head_flops": head_flops, "bytes": nbytes, "square": square}


def time_ssd() -> dict:
    """Times at the prefill's SSD shape: the kernel (CUDA events over
    back-to-back calls of the wrapper; its device time comes from the
    prefill's profile and from ``ssd_device_ms``) and its plain version.
    No one PyTorch call computes this function, so there is no library
    time.  The bound is that of the route bf16 x takes, the larger of the
    bytes over the HBM rate and its products at the TF32 tensor-core peak:
    operands split hi + lo, three products for C.B^T (both operands fp32),
    two for W.X and the state product (bf16 x is exact in TF32, its lo 0).
    Beside it the bound of fp32 on the CUDA cores, the FLOP over the fp32
    peak.  TFLOP/s counts the FLOP the function needs, and each share is a
    bound over the measured time."""
    assert SSD_PREFILL[-1] == torch.bfloat16
    args = ssd_inputs(SSD_PREFILL, 1)
    work = ssd_work(SSD_PREFILL)
    flops, nbytes = work["flops"], work["bytes"]
    bound_ops = ((3 * work["cb_flops"] + 2 * work["head_flops"])
                 / TF32_FLOPS_PER_S * 1e3)
    bound_fp32 = flops / FP32_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        res = {"ms": events_ms(lambda: ss.ssd_intra_chunk_fwd(*args), 10,
                               inner=5),
               "plain_ms": events_ms(lambda: ssd_intra_chunk_ref(*args), 5),
               "library_ms": None}
    bound = max(bound_ops, bound_bytes)
    res.update(flops=flops, cb_flops=work["cb_flops"],
               flops_full_square=work["square"], bytes=nbytes,
               bound_ms=bound,
               bound_by="operations" if bound_ops >= bound_bytes else "bytes",
               ops_bound_ms=bound_ops, bytes_bound_ms=bound_bytes,
               fp32_bound_ms=bound_fp32,
               tflops=flops / (res["ms"] * 1e-3) / 1e12,
               bound_share=bound / res["ms"],
               fp32_bound_share=bound_fp32 / res["ms"])
    log("[time] ssd_intra_chunk_fwd " + json.dumps(
        {"shape": list(SSD_PREFILL[:6]) + ["bfloat16"], **res}))
    return res


def ssd_device_ms() -> dict:
    """Device ms per call of the SSD wrapper at the prefill's shape, from a
    profiler trace (``device_ms``) that must hold exactly one device event
    per call: a call is one kernel.  Deterministic algorithms are off here
    (a fresh process), so the outputs get no NaN fill."""
    args = ssd_inputs(SSD_PREFILL, 1)
    with torch.inference_mode():
        ms = device_ms(lambda: ss.ssd_intra_chunk_fwd(*args))
    flops = ssd_work(SSD_PREFILL)["flops"]
    return {"device_ms": ms, "events_per_call": 1,
            "tflops": flops / (ms * 1e-3) / 1e12}


def prefill(eng, kernel=fa.flash_attention_fwd, mix=_attention_mix,
            tols=PREFILL_REL_TOL, fp32: bool = True) -> dict:
    """Full-width prefill through ``build_prefill_step`` with the kernel
    switch (``use_flash_kernel``) on: B x S tokens from numpy seed 0 on the
    serve phase's weights.  Gates the logits' shape and finiteness, one
    launch of ``kernel`` per layer per forward, and agreement with the same
    forward on the plain path (``attend_full``, since S <= 2 * attn_chunk,
    or the plain chunked SSD), end to end and per layer (``mix`` is the
    layer's mixer), within ``tols`` (keys missing there are printed, not
    gated); with ``fp32``, also the whole model widened to fp32."""
    cfg = dataclasses.replace(eng.cfg, use_flash_kernel=True)
    step = build_prefill_step(get_model(cfg, "cuda"))
    plain_step = build_prefill_step(get_model(eng.cfg, "cuda"))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0                      # the main path: counts from 0
    t0 = time.perf_counter()
    logits = step(eng.params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    want = (PREFILL_B, PREFILL_S, cfg.padded_vocab)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, "
                             f"want {want} and finite")
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} kernel launches in one forward, "
                             f"want {cfg.n_layers}")
    plain = plain_step(eng.params, batch)
    if kernel.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    agree = {"bf16": rel_max_diff(logits, plain),
             "argmax_agreement": float((logits.argmax(-1)
                                        == plain.argmax(-1)).float().mean()),
             "bf16_layer": check_layers(eng.params, eng.cfg, batch["tokens"],
                                        mix)}
    del logits, plain
    if fp32:
        agree["fp32"] = prefill_fp32(eng, batch)
    log(f"[prefill] {cfg.name}: kernel vs plain path, max |diff| / max "
        f"|ref|: " + json.dumps(agree))
    for key, tol in tols.items():
        if not agree[key] <= tol:
            raise AssertionError(f"kernel and plain prefill differ ({key}): "
                                 f"{agree[key]} > {tol}")
    wall = wall_s(lambda: step(eng.params, batch), 3)
    plain_wall = wall_s(lambda: plain_step(eng.params, batch), 3)
    # the kernel's device time from this profile, where each of its
    # launches must show (profiles of back-to-back calls of the wrapper
    # alone have held fewer launches than were made)
    prof = profile_window(lambda: step(eng.params, batch),
                          KERNEL_NAMES[kernel])
    for name, (count, _) in prof["named"].items():
        if count != launches:
            raise AssertionError(f"the prefill's profile holds {count} "
                                 f"{name} kernels, not {launches}")
    tokens_n = PREFILL_B * PREFILL_S
    out = {"launches": launches, "first_call_s": first_s,
           "wall_ms": wall * 1e3, "tokens_per_s": tokens_n / wall,
           "plain_wall_ms": plain_wall * 1e3,
           "plain_tokens_per_s": tokens_n / plain_wall,
           "max_memory_allocated": peak, "profile": prof,
           "kernel_device_ms": sum(
               ms for _, ms in prof["named"].values()) / launches, **agree}
    log(f"[prefill] {cfg.name} B={PREFILL_B} S={PREFILL_S} bf16, kernel "
        f"path: " + json.dumps(out))
    return out


def rel_max_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, one slice of the leading axis at a
    time (full-width logits are gigabytes)."""
    diff = max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))
    return diff / max(float(w.float().abs().max()) for w in want)


def check_layers(params, cfg, tokens, mix=_attention_mix) -> float:
    """Each layer's mixer (``mix``), prefix layers first, on the hidden
    state the kernel forward feeds it, through the kernel and through the
    plain path: the largest relative difference over the layers."""
    flash_cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    layers = [(params[f"prefix{i}"], spec)
              for i, spec in enumerate(cfg.prefix)]
    for r in range(cfg.n_repeats):
        rep = params["blocks"].at(r)
        layers += [(rep[f"layer{i}"], spec)
                   for i, spec in enumerate(cfg.block)]
    worst = 0.0
    with torch.inference_mode():
        x = embed_tokens(params["embed"], tokens).to(getattr(torch,
                                                             cfg.dtype))
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b,
                                                                        s)
        aux = torch.zeros((), device=x.device)
        for p, spec in layers:
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            worst = max(worst, rel_max_diff(mix(p, h, pos, flash_cfg),
                                            mix(p, h, pos, cfg)))
            x, aux = transformer._apply_layer(p, spec, x, pos, flash_cfg,
                                              aux)
    return worst


def prefill_fp32(eng, batch) -> float:
    """The full-width prefill in fp32 (the serve weights widened), kernel
    path against plain path: the relative difference of the logits."""
    params, cfg = widened(eng.params, eng.cfg, "float32")
    flash = build_prefill_step(get_model(
        dataclasses.replace(cfg, use_flash_kernel=True), "cuda"))(params,
                                                                  batch)
    plain = build_prefill_step(get_model(cfg, "cuda"))(params, batch)
    out = rel_max_diff(flash, plain)
    del params, flash, plain
    torch.cuda.empty_cache()
    return out


def mixer_counts(cfg) -> dict:
    """Launches of each prefill kernel in one forward of ``cfg``: one per
    layer of its mixer."""
    specs = list(cfg.prefix) + list(cfg.block) * cfg.n_repeats
    return {fa.flash_attention_fwd: sum(s.mixer == "attn" for s in specs),
            ss.ssd_intra_chunk_fwd: sum(s.mixer == "mamba" for s in specs)}


def check_forward_on_small_input(arch: str = ARCH) -> None:
    """Reduced ``arch`` in fp32: the card's forward through the kernels
    (one launch per layer of their mixer) agrees with the CPU's plain
    forward on the same weights and tokens at 5e-4 (the reference's
    tolerance for the kernel inside the model,
    tests/test_kernels.py:96-115), each MoE layer's expert choices first,
    exactly."""
    cfg = get_config(arch).reduced()
    cpu, card = small_models(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 96), dtype=np.int32))
    with recording_routes() as rc:
        want = build_prefill_step(get_model(cfg, "cpu"))(cpu,
                                                         {"tokens": tokens})
    n0 = {k: k.launches for k in KERNEL_NAMES}
    with recording_routes() as rg:
        got = build_prefill_step(get_model(
            dataclasses.replace(cfg, use_flash_kernel=True), "cuda"))(
                card, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    if {k: k.launches - n for k, n in n0.items()} != mixer_counts(cfg):
        raise AssertionError("the reduced forward did not launch each "
                             "kernel once per layer of its mixer")
    compare_routes(rc, rg, f"reduced {arch} forward")
    if not torch.allclose(got.cpu(), want, atol=5e-4, rtol=5e-4):
        raise AssertionError(f"reduced forward: card and CPU differ by "
                             f"{max_abs_err(got.cpu(), want)}")
    log(f"[check] reduced fp32 {arch} forward (kernel path) == CPU within "
        f"5e-4; max_abs_err {max_abs_err(got.cpu(), want):.3e}")


def train(eng) -> dict:
    """Full-width training through ``build_train_step`` with the reference
    defaults (AdamW lr 1e-4, weight decay 0.01, clip 1.0, block remat, the
    plain attention path) on the serve phase's weights, updated in place:
    TRAIN_STEPS steps on one fixed batch from ``input_specs`` (seed 0).
    Gates finite loss and grad norm and a loss that falls."""
    api = get_model(eng.cfg, "cuda")
    batch = api.input_specs(ShapeSpec("smoke_train", TRAIN_S, TRAIN_B,
                                      "train"), abstract=False, seed=0)
    step = build_train_step(api, TrainStepConfig())
    opt = opt_state_for(eng.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, opt, metrics = step(eng.params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms)
    out = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "median_step_ms": med,
           "tokens_per_s": TRAIN_B * TRAIN_S / (med * 1e-3),
           "max_memory_allocated": peak}
    log(f"[train] {eng.cfg.name} B={TRAIN_B} S={TRAIN_S} bf16, "
        f"{TRAIN_STEPS} steps: " + json.dumps(out))
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {out}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    del opt
    return out


def check_train_step_on_small_input(arch: str = ARCH) -> None:
    """Reduced ``arch`` in fp32 (2 layers, or one super-block where that
    is longer): one train step on the card agrees with the CPU's on the
    same weights and batch: loss and grad norm at rtol 1e-4, new
    parameters at rtol 2e-2, atol 2e-4 (the port's CPU test against the
    reference, tests/test_torch_forward.py)."""
    base = get_config(arch)
    cfg = base.reduced(n_layers=max(2, len(base.prefix) + len(base.block)))
    cpu, card = small_models(cfg)
    shape = ShapeSpec("s", 32, 4, "train")
    api_c, api_g = get_model(cfg, "cpu"), get_model(cfg, "cuda")
    batch = api_c.input_specs(shape, abstract=False, seed=0)
    _, _, mc = build_train_step(api_c)(cpu, opt_state_for(cpu), batch)
    _, _, mg = build_train_step(api_g)(
        card, opt_state_for(card), {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    for key in ("loss", "grad_norm"):
        if not np.isclose(float(mg[key]), float(mc[key]), rtol=1e-4):
            raise AssertionError(f"reduced train step {key}: card "
                                 f"{float(mg[key])}, CPU {float(mc[key])}")
    want = cpu.state_dict()
    for k, t in card.state_dict().items():
        if not torch.allclose(t.cpu(), want[k], rtol=2e-2, atol=2e-4):
            raise AssertionError(f"reduced train step: {k} differs by "
                                 f"{max_abs_err(t.cpu(), want[k])}")
    log(f"[check] reduced fp32 {arch} train step: card == CPU (loss "
        f"{float(mg['loss']):.6f} vs {float(mc['loss']):.6f})")


# ----------------------------------------------------------------------
# TENSILE: quantize kernels, the quickstart MLP, the full-width train step
# ----------------------------------------------------------------------
def packed_buffer(n: int) -> torch.Tensor:
    """A pinned packed buffer for ``n`` elements, as the executor allocates
    one for a compressed swap-out (no deterministic fill)."""
    return tensile_executor.empty_unfilled((oq.packed_bytes(n),), (1,),
                                           torch.int8, pin=True)


def packing(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The bytes a packed buffer must hold for rows ``q`` and scales ``s``,
    on the host."""
    return torch.cat([q.reshape(-1).cpu(),
                      s.reshape(-1).cpu().view(torch.int8)])


def quant_input(shape, dtype, gen, misaligned: bool) -> torch.Tensor:
    """A seeded input on the card; with ``misaligned``, a contiguous view
    one element into its storage (not 16-byte aligned)."""
    n = math.prod(shape)
    flat = (torch.randn(n + 1, generator=gen, device="cuda") * 3).to(dtype)
    return (flat[1:] if misaligned else flat[:n].clone()).view(shape)


def quant_out(shape, dtype, misaligned: bool) -> torch.Tensor:
    n = math.prod(shape)
    flat = torch.empty(n + 1, dtype=dtype, device="cuda")
    return (flat[1:] if misaligned else flat[:n]).view(shape)


def check_quant(cases=None) -> dict:
    """Both quantize kernels against their plain versions on the card, on
    every route of a swap: card to card (the reference's signature), card
    to a packed pinned buffer, and that buffer to the card, read by the
    kernel or first copied whole (the executor's two swap-in routes).
    int8 rows, scales and meta bit-exact, dequantized values exact, for
    fp32, bf16 and fp16 inputs at ragged lengths and one 64 MiB fp32
    tensor (or at the ``(shape, dtype)`` pairs of ``cases``), each once
    from an aligned tensor and once from a view one element into its
    storage (scalar path), with outputs placed alike.  The packed buffer is filled with a
    sentinel first and must then hold the plain packing byte for byte:
    the kernel writes every byte of it.  One launch per call.  fp32 round
    trips within the reference's bound (absmax/127 per element,
    tests/test_kernels.py:71-82).  Returns the largest kernel vs plain
    difference (0.0 when all pass), the largest fp32 round-trip error over
    its bound, and the sentinel bytes left where the packing differs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, worst_rt, stray = 0.0, 0.0, 0
    if cases is None:
        cases = [(s, d) for d in (torch.float32, torch.bfloat16,
                                  torch.float16)
                 for s in QUANT_SHAPES] + [(QUANT_BIG, torch.float32)]
    for shape, dtype in cases:
        for misaligned in (False, True):
            x = quant_input(shape, dtype, gen, misaligned)
            qr, sr, mr = quantize_blocked_ref(x)
            xp = dequantize_blocked_ref(qr, sr, mr)
            want = packing(qr, sr)
            nq = oq.quantize_blocked.launches
            nd = oq.dequantize_blocked.launches
            q, s, meta = oq.quantize_blocked(x)
            xd = oq.dequantize_blocked(q, s, meta, out=quant_out(
                shape, dtype, misaligned))
            buf = packed_buffer(x.numel()).fill_(QUANT_SENTINEL)
            qh, sh, mh = oq.quantize_blocked(x, out=buf)
            xh = oq.dequantize_blocked(qh, sh, mh, out=quant_out(
                shape, dtype, misaligned))
            xc = tensile_executor.fetch_packed(qh, sh, mh, quant_out(
                shape, dtype, misaligned), copy=True)
            torch.cuda.synchronize()
            launched = (oq.quantize_blocked.launches - nq,
                        oq.dequantize_blocked.launches - nd)
            worst = max(worst, max_abs_err(q, qr), max_abs_err(s, sr),
                        max_abs_err(xd, xp), max_abs_err(xh, xp),
                        max_abs_err(xc, xp))
            stray += int(((buf == QUANT_SENTINEL)
                          & (want != QUANT_SENTINEL)).sum())
            same = {"q": torch.equal(q, qr), "s": torch.equal(s, sr),
                    "meta": meta == mr == mh,
                    "card_to_card": torch.equal(xd, xp),
                    "card_to_pinned": torch.equal(buf, want)
                    and qh.data_ptr() == buf.data_ptr(),
                    "pinned_to_card": torch.equal(xh, xp),
                    "copy_to_card": torch.equal(xc, xp),
                    "one_launch_per_call": launched == (2, 3)
                    or x.numel() == 0}
            if not all(same.values()):
                raise AssertionError(f"quantize kernels differ at {shape} "
                                     f"{dtype} misaligned={misaligned}: "
                                     f"{same}, max_abs_err {worst}")
            if dtype == torch.float32:
                bound = (float(x.abs().max()) / 127.0 + 1e-7) * 1.01
                err = max_abs_err(xh, x)
                worst_rt = max(worst_rt, err / bound)
                if err > bound:
                    raise AssertionError(f"round trip at {shape}: {err} > "
                                         f"{bound}")
            log(f"[quant] bit-exact on every route: {shape} {dtype}"
                f"{' misaligned' if misaligned else ''}")
    return {"max_abs_err": worst, "round_trip_err_over_bound": worst_rt,
            "stray_sentinel_bytes": stray}


def quant_calls(shape, dtype) -> tuple:
    """A seeded input of one shape, its quantized rows, and (name, wrapper
    call, plain call) of both quant kernels on them, card to card."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, s, meta = oq.quantize_blocked(x)
    return x, q, (("quantize_blocked", lambda: oq.quantize_blocked(x),
                   lambda: quantize_blocked_ref(x)),
                  ("dequantize_blocked",
                   lambda: oq.dequantize_blocked(q, s, meta),
                   lambda: dequantize_blocked_ref(q, s, meta)))


def swap_calls(x: torch.Tensor) -> dict:
    """A compressed swap of ``x`` each way, as the executor made it before
    (``old``: the wrappers' card outputs staged through two pinned buffers
    and two copies; two copies back, then the dequantize) and makes it now
    (``new``: one quantize launch into a packed pinned buffer; back by the
    executor's size rule, ``fetch_packed``), and the swap-in by each route
    of that rule: one dequantize launch reading the pinned buffer
    (``zero_copy``), or one copy of the buffer to the card and a
    card-to-card dequantize (``copy``)."""
    n = x.numel()
    q, s, meta = oq.quantize_blocked(x)
    hq, hs = q.cpu().pin_memory(), s.cpu().pin_memory()
    buf = packed_buffer(n)
    qh, sh, _ = oq.quantize_blocked(x, out=buf)
    dst = torch.empty_like(x)

    def old_out():
        for t in oq.quantize_blocked(x)[:2]:
            h = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                    device="cpu", pin_memory=True)
            h.copy_(t, non_blocking=True)

    def new_out():
        oq.quantize_blocked(x, out=packed_buffer(n))

    def old_in():
        oq.dequantize_blocked(hq.to("cuda", non_blocking=True),
                              hs.to("cuda", non_blocking=True), meta,
                              out=dst)

    def fetch(copy):
        return lambda: tensile_executor.fetch_packed(qh, sh, meta, dst, copy)

    return {"out": {"old": old_out, "new": new_out},
            "in": {"old": old_in, "new": fetch(None),
                   "zero_copy": fetch(False), "copy": fetch(True)}}


def quant_device_ms(shape, dtype: str) -> dict:
    """Device ms per call of both quant wrappers at one shape, from
    profiler traces (``device_ms``) with deterministic algorithms off, so
    a call is its one kernel (no NaN fill of its output): card to card,
    and a compressed swap each way as the executor makes it: one kernel
    and no copy per call, except a swap-in above the zero-copy size, which
    copies the packed buffer first (``device_ms`` raises on any other
    count)."""
    x, _, calls = quant_calls(tuple(shape), getattr(torch, dtype))
    out = {name: device_ms(fn) for name, fn, _ in calls}
    swap = swap_calls(x)
    out["swap_out"] = device_ms(swap["out"]["new"])
    copied = (oq.packed_bytes(x.numel())
              > tensile_executor.ZERO_COPY_MAX_BYTES)
    out["swap_in"] = device_ms(swap["in"]["new"], per_call=1 + copied)
    return out


def start_fresh(phase: str, *args) -> subprocess.Popen:
    """Start ``FRESH_PHASES[phase](*args)`` in a new process of this
    script; ``finish_fresh`` collects it."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--fresh", phase, json.dumps(args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_fresh(proc: subprocess.Popen, phase: str, timeout: int = 600):
    """The result of a process from ``start_fresh``; its log lines are
    printed here.  Raises if it failed or outlived ``timeout`` seconds
    (it is killed then)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{phase} timed out in a fresh process:\n"
                             + out + err)
    if proc.returncode != 0:
        raise AssertionError(f"{phase} failed in a fresh process:\n"
                             + out + err)
    *lines, result = out.strip().splitlines()
    for line in lines:
        log(line)
    return json.loads(result)


def in_fresh_process(phase: str, *args, timeout: int = 600):
    """Run ``FRESH_PHASES[phase](*args)`` in a new process of this script
    and return its result; the child's log lines are printed here.  Late in
    a run, profiler traces lose events (``device_ms``); a fresh process's
    do not."""
    return finish_fresh(start_fresh(phase, *args), phase, timeout)


def time_quant(shape, dtype, link: dict) -> dict:
    """Times at one shape (CUDA events over back-to-back calls): both
    wrappers card to card and their plain versions, with the byte bound at
    3.35 TB/s (quantize reads n * itemsize and writes n + 4 R bytes,
    dequantize the reverse); and a compressed swap each way by the old and
    the new route (``swap_calls``), timed in turns, with the link bound:
    the wire bytes n + 4 R over the measured pinned rate of the
    direction."""
    x, q, calls = quant_calls(shape, dtype)
    n, rows = x.numel(), q.shape[0]
    moved = n * x.element_size() + n + 4 * rows
    wire = n + 4 * rows
    res = {}
    for name, fn, plain in calls:
        res[name] = {"ms": events_ms(fn, 10, inner=10),
                     "plain_ms": events_ms(plain, 5, inner=2),
                     "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                     "bytes": moved, "shape": list(shape),
                     "dtype": str(dtype).replace("torch.", "")}
    inner = 10 if n < (1 << 22) else 2
    swap = swap_calls(x)
    for way, rate, name in (("out", "d2h_bytes_per_s", "quantize_blocked"),
                            ("in", "h2d_bytes_per_s", "dequantize_blocked")):
        fns = swap[way]
        times = events_turns(list(fns.values()), 10, inner=inner)
        res[name]["swap_ms"] = dict(zip(fns, times))
        res[name]["link_bound_ms"] = wire / link[rate] * 1e3
        res[name]["wire_bytes"] = wire
    res["quantize_source_bytes_per_s"] = (
        n * x.element_size() / (res["quantize_blocked"]["ms"] * 1e-3))
    log("[time] quant " + json.dumps(res))
    return res


def quant_swap_in_ladder() -> dict:
    """A compressed swap-in by each route (``swap_calls``: ``zero_copy``,
    ``copy``) at each fp32 length of QUANT_LADDER, in turns, beside the
    executor's rule (a zero-copy read up to ZERO_COPY_MAX_BYTES of packed
    buffer)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    ladder = {}
    for n in QUANT_LADDER:
        calls = swap_calls(torch.randn(n, generator=gen, device="cuda"))["in"]
        t_zero, t_copy = events_turns([calls["zero_copy"], calls["copy"]],
                                      10, inner=10 if n < (1 << 20) else 3)
        ladder[oq.packed_bytes(n)] = {"zero_copy_ms": t_zero,
                                      "copy_ms": t_copy}
    out = {"zero_copy_max_bytes": tensile_executor.ZERO_COPY_MAX_BYTES,
           "ladder": ladder}
    log("[quant] swap-in routes by packed bytes: " + json.dumps(out))
    return out


def quant_cta_sweep(link: dict) -> dict:
    """The host routes' CTA cap: a compressed swap of 64 MiB fp32 each way
    (card to packed pinned buffer, buffer to card) at each CTA count of
    QUANT_CTA_SWEEP, timed in turns with CUDA events, as a share of the
    measured pinned link rate of its direction.  Each direction's cap is
    the smallest count that reaches 90 % (``kQuantHostCtas`` and
    ``kDequantHostCtas`` in the source)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(QUANT_BIG, generator=gen, device="cuda")
    n = x.numel()
    wire = oq.packed_bytes(n)
    qh, sh, _ = oq.quantize_blocked(x, out=packed_buffer(n))
    dst = torch.empty_like(x)
    # the C entries with a grid cap, as the wrappers launch them otherwise
    lib = oq._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(entry, *args):
        err = entry(*args)
        if err:
            raise AssertionError(lib.offload_quant_error_string(err))

    fns = []
    for c in QUANT_CTA_SWEEP:
        fns.append(lambda c=c: launch(
            lib.offload_quantize, x.data_ptr(), 0, n, qh.data_ptr(),
            sh.data_ptr(), qh.shape[0], 1, c, stream))
        fns.append(lambda c=c: launch(
            lib.offload_dequantize, qh.data_ptr(), sh.data_ptr(), n,
            dst.data_ptr(), 0, 1, c, stream))
    times = events_turns(fns, 5, inner=3)
    sweep = {}
    for i, c in enumerate(QUANT_CTA_SWEEP):
        t_out, t_in = times[2 * i], times[2 * i + 1]
        sweep[c] = {"swap_out_ms": t_out, "swap_in_ms": t_in,
                    "out_link_share": wire / (t_out * 1e-3)
                    / link["d2h_bytes_per_s"],
                    "in_link_share": wire / (t_in * 1e-3)
                    / link["h2d_bytes_per_s"]}
    out = {"wire_bytes": wire, "sweep": sweep,
           "host_ctas": {"quantize": lib.offload_quant_host_ctas(0),
                         "dequantize": lib.offload_quant_host_ctas(1)}}
    log("[quant] CTA sweep at 64 MiB fp32: " + json.dumps(out))
    return out


def tensile_mlp() -> dict:
    """The quickstart on the card: the MLP (weights and data from numpy
    seed 0) captured, planned by ``schedule_single`` with the quickstart
    profile, and executed in sync mode.  Gates: the plan schedules events,
    the executor's ledger peak and decision trace equal the simulator's
    (sync transfers), and the outputs are bit-equal to the unscheduled
    executor's."""
    np_params, np_data = mlp_numpy(MLP_SIZES, MLP_BATCH, seed=0)
    step, params, opt, batch = make_mlp(MLP_SIZES, MLP_BATCH, params=np_params,
                                        data=np_data, device="cuda")
    seq, gm = capture_train_step(step, params, opt, batch,
                                 cost_model=CostModel(QUICKSTART_CALIB))
    res = schedule_single(seq, profile=QUICKSTART_PROFILE)
    plan = res.plans[seq.job_id]
    sim_eng = MemoryEngine(QUICKSTART_PROFILE, trace=True)
    sim = simulate([seq], {seq.job_id: plan}, QUICKSTART_PROFILE,
                   iterations=1, transfer_mode="sync", engine=sim_eng)
    ex_eng = MemoryEngine(QUICKSTART_PROFILE, trace=True)
    ex = FxExecutor(gm, seq, plan, engine=ex_eng)
    out = ex.run(params, opt, batch)
    ex0 = FxExecutor(gm, seq, None, engine=MemoryEngine(QUICKSTART_PROFILE))
    out0 = ex0.run(params, opt, batch)
    torch.cuda.synchronize()
    metrics = evaluate([seq], res.plans, QUICKSTART_PROFILE)
    info = {"operators": len(seq.operators), "tensors": len(seq.tensors),
            "swaps": res.swaps_scheduled,
            "recomputes": res.recomputes_scheduled,
            "events": len(plan.events),
            "predicted_peak": res.final_report.peak_bytes,
            "sim_peak": sim.peak_bytes, "executor_peak": ex.stats.peak_bytes,
            "unscheduled_peak": ex0.stats.peak_bytes,
            "trace_records": len(ex_eng.trace.keys()),
            "swap_outs": ex.stats.swap_out_count,
            "swap_ins": ex.stats.swap_in_count,
            "simulated_MSR": metrics["MSR"], "simulated_EOR": metrics["EOR"]}
    log("[tensile_mlp] " + json.dumps(info))
    if not plan.events:
        raise AssertionError("the quickstart plan schedules nothing")
    if ex.stats.peak_bytes != sim.peak_bytes:
        raise AssertionError(f"executor peak {ex.stats.peak_bytes} != "
                             f"simulated {sim.peak_bytes}")
    if ex_eng.trace.keys() != sim_eng.trace.keys():
        raise AssertionError("executor and simulator decision traces differ")
    # a storage the plan parks on the host comes back as a host tensor
    if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(out, out0)):
        raise AssertionError("scheduled MLP outputs differ from unscheduled")
    return info


def _tensile_state(cfg, batch) -> list:
    """A fresh full-width train state as a flat list of leaves in the
    step's argument order: parameters from a CUDA generator seeded 0, zero
    AdamW moments, the fixed batch.  Nothing else keeps a reference to the
    parameters, so the executor can free what the plan frees."""
    params = dict(get_model(cfg, "cuda").init(torch.Generator(
        device="cuda").manual_seed(0)).named_parameters())
    return pytree.tree_leaves([params, adamw_init(params), batch])


def _run_state(ex, state: list, base: int) -> tuple:
    """One executor iteration on the donated ``state``; returns the
    outputs, wall seconds, the allocator's peak over the run (reset before
    it) less ``base`` (what was allocated before the state existed), and
    the executor's ledger peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = ex.run_donated(state)
    wall = time.perf_counter() - t0
    return (outs, wall, torch.cuda.max_memory_allocated() - base,
            ex.stats.peak_bytes)


def _plan(seq, profile, name: str, budget: int):
    cfg = SchedulerConfig(memory_budget_bytes=budget,
                          patience_iters=PLAN_PATIENCE)
    if name == COMPRESSED_FIRST:
        pipeline = Pipeline([CompressedOffloadPass(), SwapPass(),
                             RecomputePass()], name=name, profile=profile,
                            config=cfg)
    else:
        pipeline = build_pipeline(name, profile, cfg)
    ms = MemoryScheduler(profile, cfg, pipeline=pipeline)
    ms.register_job(seq)
    t0 = time.perf_counter()
    res = ms.schedule()
    return res, time.perf_counter() - t0


def _uncompressed(plan):
    """``plan`` with every event's compressed flag cleared."""
    out = SchedulingPlan(plan.job_id)
    for e in plan.events:
        out.add(dataclasses.replace(e, compressed=False))
    out.release_after_op.update(plan.release_after_op)
    return out


def _channel_share(seq, plan) -> float:
    """The share of the iteration the plan books on the host link."""
    return sum(e.duration for e in plan.events if e.event_type.value in (
        "swap_out", "swap_in")) / seq.iteration_time


def _event_counts(seq, plan) -> dict:
    c = collections.Counter()
    for e in plan.events:
        c[e.event_type.value] += 1
        if e.crosses_iteration:
            c["across_iteration"] += 1
        if e.compressed:
            c[f"compressed_{e.event_type.value}_"
              f"{seq.tensors[e.tensor_id].kind.value}"] += 1
    return dict(c)


def _host_copy(outs) -> list:
    return [o.detach().to("cpu", copy=True) for o in outs]


def _update_diffs(outs, ref, old, groups) -> dict:
    """Per group of state leaf positions, for each leaf i, the update
    ``d_c = outs_i - old_i`` against the exact update ``d_e = ref_i -
    old_i`` (fp64 on the card, one leaf at a time): cosine (0 where
    ``d_c`` is zero), ``||d_c|| / ||d_e||`` and ``||d_c - d_e|| /
    ||d_e||``.  Returns each one's median over the leaves with a nonzero
    exact update, the worst leaf by cosine, the count of leaves without an
    exact update and the count of non-finite entries of ``outs``."""
    out = {}
    for name, idx in groups.items():
        cos, ratio, rel, bad = [], [], [], 0
        for i in idx:
            a = outs[i].to("cuda", torch.float64)
            o = old[i].to("cuda", torch.float64)
            d_e = ref[i].to("cuda", torch.float64) - o
            d_c = a - o
            bad += int((~torch.isfinite(a)).sum())
            n_e, n_c = float(d_e.norm()), float(d_c.norm())
            if n_e > 0:
                cos.append((float((d_c * d_e).sum()) / (n_c * n_e)
                            if n_c > 0 else 0.0, i))
                ratio.append(n_c / n_e)
                rel.append(float((d_c - d_e).norm()) / n_e)
        out[name] = {"cosine": statistics.median(c for c, _ in cos),
                     "ratio": statistics.median(ratio),
                     "rel_l2": statistics.median(rel),
                     "min_cosine": min(cos)[0], "worst_leaf": min(cos)[1],
                     "no_update": len(idx) - len(cos), "nonfinite": bad}
    return out


def _update_failures(diffs: dict) -> list:
    """What of ``diffs`` breaks COMPRESSED_TOL: a group with non-finite
    entries, a median cosine under its limit, a median ratio outside its
    band."""
    lo, hi = COMPRESSED_TOL["ratio"]
    fails = []
    for k, v in diffs.items():
        if v["nonfinite"]:
            fails.append(f"{k}: non-finite")
        if not v["cosine"] >= COMPRESSED_TOL["cosine"]:
            fails.append(f"{k}: cosine {v['cosine']} < "
                         f"{COMPRESSED_TOL['cosine']}")
        if not lo <= v["ratio"] <= hi:
            fails.append(f"{k}: ratio {v['ratio']} outside {lo}-{hi}")
    return fails


def _scheduled(gm, seq, plan, profile, cfg, batch, n_state: int, tag: str,
               check, base: int, exact: bool = False) -> tuple:
    """TENSILE_ITERS async iterations from a fresh state, the storages
    parked on the host at each iteration's end carried into the next as
    host-resident inputs.  ``check(k, outs, ref)`` returns extra fields for
    iteration k; with ``exact``, ``ref`` holds host copies of the
    unscheduled step's outputs from the same state (``outs``) and of that
    state (``old``), else it is None.  Returns the records, the final
    state and its host set."""
    torch.cuda.empty_cache()
    state = _tensile_state(cfg, batch)
    batch_leaves = pytree.tree_leaves(batch)
    host_inputs: set = set()
    recs = []
    for k in range(TENSILE_ITERS):
        ref = None
        if exact:
            ref = {"outs": _host_copy(FxExecutor(gm, seq, None, engine=(
                MemoryEngine(profile))).run(state)),
                "old": _host_copy(state[:n_state])}
            torch.cuda.empty_cache()
        ex = FxExecutor(gm, seq, plan, async_swap=True,
                        host_resident_inputs=host_inputs,
                        engine=MemoryEngine(profile))
        outs, wall, alloc, ledger = _run_state(ex, state, base)
        rec = {"iteration": k + 1, "wall_s": wall,
               "max_memory_allocated": alloc, "ledger_peak": ledger,
               "swap_outs": ex.stats.swap_out_count,
               "swap_ins": ex.stats.swap_in_count,
               "passive_swap_ins": ex.stats.passive_swap_ins,
               "recomputes": ex.stats.recompute_count,
               "compressed_swaps": ex.stats.compressed_swaps,
               "host_stall_s": ex.stats.stall_time_s,
               "transfer_launches": len(ex.async_exec.batches),
               "loss": float(outs[n_state]),
               "parked_at_end": len(ex.ending_host_storages())}
        rec.update(check(k, outs, ref))
        recs.append(rec)
        log(f"[tensile] {tag} " + json.dumps(rec))
        host_inputs = ex.ending_host_storages()
        state = outs[:n_state] + batch_leaves
        del ex, outs, ref
    return recs, state, host_inputs


def _forward_reads(gm, seq, plan, loss_pos: int) -> tuple:
    """The loss's operator and the plan's compressed swap-ins whose target
    operator comes at or before it (a forward operator), in target order,
    each with its tensor, the tensor's producer and its swap-out."""
    lay = graph_layout(gm)
    loss_tid = lay.tid[lay.owner[lay.out_leaves[loss_pos]]]
    loss_op = next(op.idx for op in seq.operators if loss_tid in op.outputs)
    producer = {t: op for op in seq.operators for t in op.outputs}
    outs = collections.defaultdict(list)
    for e in plan.events:
        if e.compressed and e.event_type.value == "swap_out":
            outs[e.tensor_id].append(e.trigger_op)
    reads = []
    for e in sorted((e for e in plan.events if e.compressed
                     and e.event_type.value == "swap_in"
                     and e.target_op is not None
                     and e.target_op <= loss_op),
                    key=lambda e: e.target_op):
        t, p = seq.tensors[e.tensor_id], producer.get(e.tensor_id)
        reads.append({
            "tensor": e.tensor_id, "kind": t.kind.value,
            "shape": list(t.shape), "dtype": t.dtype,
            "producer": f"{p.idx} {p.name}" if p else None,
            "swapped_out_after_op": max(
                (o for o in outs[e.tensor_id] if o < e.target_op),
                default=None),
            "read_by_op": f"{e.target_op} "
                          f"{seq.operators[e.target_op].name}"})
    return loss_op, reads


def tensile_capture(link: dict, quant_bw: float) -> dict:
    """The full-width TinyLlama train step of ``tensile_train`` (B 4,
    S 1024, no remat) captured on fake tensors: its config, batch, access
    sequence and graph, parameter names, the machine profile from the
    measured host link and quantize rate, and the unscheduled planned
    peak."""
    cfg = dataclasses.replace(get_config(ARCH), remat="none",
                              n_layers=TENSILE_LAYERS)
    api = get_model(cfg, "cuda")
    batch = api.input_specs(ShapeSpec("tensile_train", TRAIN_S, TRAIN_B,
                                      "train"), abstract=False, seed=0)
    step = build_functional_train_step(api, TrainStepConfig())
    calib = calibrate_cuda()
    log(f"[tensile] calibrate_cuda: {calib.flops:.4e} flop/s, "
        f"{calib.mem_bw:.4e} B/s")
    params = dict(get_model(cfg, "cuda").shell().named_parameters())
    t0 = time.perf_counter()
    # traced on fake tensors: the arguments' shapes, dtypes and device only
    args = pytree.tree_map(lambda p: torch.empty_like(p, device="cuda"),
                           (params, adamw_init(params)))
    seq, gm = capture_train_step(step, *args, batch,
                                 cost_model=CostModel(calib))
    capture_s = time.perf_counter() - t0
    profile = MachineProfile(host_link_bw=link["host_link_bw"],
                             host_link_latency=link["host_link_latency"],
                             dma_batch_overhead=link["dma_batch_overhead"],
                             offload_quant_bw=quant_bw)
    unsched_peak = simulate([seq], None, profile, iterations=1,
                            transfer_mode="sync").peak_bytes
    log(f"[tensile] captured {len(seq.operators)} operators, "
        f"{len(seq.tensors)} tensors in {capture_s:.2f} s; unscheduled "
        f"planned peak {unsched_peak} B")
    return {"cfg": cfg, "batch": batch, "seq": seq, "gm": gm,
            "names": list(params), "profile": profile,
            "unsched_peak": unsched_peak, "capture_s": capture_s}


def tensile_train(link: dict, quant_bw: float) -> dict:
    """The paper's loop at full width: capture the train step on fake
    tensors, plan it under a budget, execute it (see the module
    docstring).  Returns what the kernel table and the report need."""
    cap = tensile_capture(link, quant_bw)
    cfg, batch, seq, gm, names, profile, unsched_peak, capture_s = (
        cap[k] for k in ("cfg", "batch", "seq", "gm", "names", "profile",
                         "unsched_peak", "capture_s"))
    n_params = len(names)
    n_state = 1 + 3 * n_params                 # params, step, mu, nu
    groups = {"params": range(n_params),
              "mu": range(n_params + 1, 2 * n_params + 1),
              "nu": range(2 * n_params + 1, 3 * n_params + 1)}

    # what the card holds before any train state exists (the allocator's
    # readings below are net of it)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    log(f"[tensile] allocated before the train state: {base} B")

    # ---- unscheduled: twice from the same state.  The first run times
    # each operator (synchronised), and its latencies replace the analytic
    # ones in the sequence, as the paper's runtime feeds measured latencies
    # back; the second run is the timed one ----------------------------
    unsched = []
    analytic_s = seq.iteration_time
    for measure in (True, False):
        torch.cuda.empty_cache()
        ex = FxExecutor(gm, seq, None, engine=MemoryEngine(profile),
                        measure_latency=measure)
        outs, wall, alloc, ledger = _run_state(
            ex, _tensile_state(cfg, batch), base)
        unsched.append({"wall_s": wall, "max_memory_allocated": alloc,
                        "ledger_peak": ledger})
        if measure:
            seq.set_latencies(ex.stats.op_latencies)
            ref1 = _host_copy(outs)
        del ex, outs
    log("[tensile] unscheduled: " + json.dumps(unsched))
    log(f"[tensile] iteration time: analytic {analytic_s:.4f} s, measured "
        f"per operator {seq.iteration_time:.4f} s")

    # ---- plan: the compressed plan against an unreachable budget; the
    # peak it reaches is the budget of every scheduled run --------------
    res_c, plan_s = _plan(seq, profile, COMPRESSED_FIRST,
                          int(FLOOR_FRACTION * unsched_peak))
    plan_c = res_c.plans[seq.job_id]
    budget = res_c.final_report.peak_bytes
    counts_c = _event_counts(seq, plan_c)
    log(f"[tensile] {COMPRESSED_FIRST} plan: {json.dumps(counts_c)}, "
        f"budget {budget} B ({budget / unsched_peak:.4f} of the unscheduled "
        f"planned peak), host link booked {_channel_share(seq, plan_c):.3f}"
        f" of the iteration, {res_c.iterations} planner iterations in "
        f"{plan_s:.2f} s")
    plans = {}
    for name in ("tensile+compressed-offload", "tensile"):
        res_n, plan_n_s = _plan(seq, profile, name, budget)
        plans[name] = (res_n, res_n.plans[seq.job_id])
        log(f"[tensile] {name} at the same budget: "
            f"{json.dumps(_event_counts(seq, plans[name][1]))}, predicted "
            f"peak {res_n.final_report.peak_bytes} B, host link booked "
            f"{_channel_share(seq, plans[name][1]):.3f} of the iteration, "
            f"{plan_n_s:.2f} s")
    res_t, plan_t = plans["tensile"]
    counts_t = _event_counts(seq, plan_t)
    missing = [f"{name}: {k}" for name, c, kinds in (
        ("compressed", counts_c, ("swap_out", "swap_in", "recompute")),
        ("tensile", counts_t, ("swap_out", "swap_in", "across_iteration")))
        for k in kinds if not c.get(k)]
    if not any(k.startswith("compressed") for k in counts_c):
        missing.append("compressed: compressed events")
    if missing:
        raise AssertionError(f"the plans lack {missing}")
    if res_c.final_report.peak_bytes > budget:
        raise AssertionError(f"predicted peak {res_c.final_report.peak_bytes}"
                             f" > budget {budget}")
    sim = {name: evaluate([seq], {seq.job_id: p}, profile, iterations=3)
           for name, p in (("compressed", plan_c), ("tensile", plan_t))}
    log("[tensile] simulated (3 iterations, vs no-free vanilla): "
        + json.dumps(sim))
    # what can change the first step's loss: compressed copies read again
    # before the loss is computed
    loss_op, fwd_reads = _forward_reads(gm, seq, plan_c, n_state)
    log(f"[tensile] loss computed by op {loss_op} "
        f"{seq.operators[loss_op].name}; {len(fwd_reads)} compressed "
        f"swap-ins read at or before it; the first: "
        f"{json.dumps(fwd_reads[:3])}")

    # ---- the uncompressed plan: every step bit-identical to the
    # unscheduled step from the same state --------------------------------
    def leaf_name(i: int) -> str:
        for g, idx in groups.items():
            if i in idx:
                return f"{g} {names[i - idx.start]}"
        return "step" if i == n_params else f"output {i}"

    def check_plain(k, outs, ref):
        bad = [(leaf_name(i), max_abs_err(a.cpu(), b))
               for i, (a, b) in enumerate(zip(outs, ref["outs"]))
               if not torch.equal(a.cpu(), b)]
        if bad:
            raise AssertionError(f"the uncompressed tensile plan's step "
                                 f"{k + 1} differs from the unscheduled step "
                                 f"in {len(bad)} of {len(outs)} outputs, "
                                 f"first {bad[:8]}; plan "
                                 f"{json.dumps(counts_t)}")
        return {"bit_identical_to_unscheduled": True}

    if not all(torch.equal(a, b) for a, b in zip(ref1, _host_copy(
            FxExecutor(gm, seq, None, engine=MemoryEngine(profile)).run(
                _tensile_state(cfg, batch))))):
        raise AssertionError("two unscheduled runs differ")
    del ref1
    plain_recs, _, _ = _scheduled(gm, seq, plan_t, profile, cfg, batch,
                                  n_state, "tensile", check_plain, base,
                                  exact=True)

    # ---- the compressed plan: the main path, each step's update against
    # the unscheduled step's from the same state ---------------------------
    def check_comp(k, outs, ref):
        loss, loss_ref = float(outs[n_state]), float(ref["outs"][n_state])
        rec = {"loss_rel_diff": abs(loss - loss_ref) / abs(loss_ref),
               "loss_bit_identical": bool(torch.equal(
                   outs[n_state].cpu(), ref["outs"][n_state])),
               "update_vs_exact_step": _update_diffs(
                   outs, ref["outs"], ref["old"], groups)}
        for g, d in rec["update_vs_exact_step"].items():
            d["worst_leaf"] = names[d["worst_leaf"] - groups[g].start]
        if k == 0:
            # the gate must reject a skipped update (cosine 0, ratio 0)
            rec["skipped_update"] = _update_diffs(
                ref["old"], ref["outs"], ref["old"], groups)
            if not _update_failures(rec["skipped_update"]):
                raise AssertionError("the update check passes a skipped "
                                     "update")
            # the same events uncompressed on the copy stream, from the same
            # state, must give the unscheduled step bit for bit: a race of
            # the copy stream shows here, where int8 rounding cannot hide it
            exact = _host_copy(FxExecutor(
                gm, seq, _uncompressed(plan_c), async_swap=True,
                engine=MemoryEngine(profile)).run_donated(
                    _tensile_state(cfg, batch)))
            if not all(torch.equal(a, b) for a, b in zip(exact,
                                                          ref["outs"])):
                raise AssertionError("the compressed plan's events, "
                                     "uncompressed, differ from the "
                                     "unscheduled step")
            rec["uncompressed_events_bit_identical"] = True
        return rec

    shapes, swaps = collections.Counter(), collections.Counter()
    oq.quantize_blocked.launches = 0          # the main path: counts from 0
    oq.dequantize_blocked.launches = 0
    tensile_executor.quantize_blocked = _spy_quant(oq.quantize_blocked,
                                                   shapes)
    try:
        with counting_swaps(swaps):
            comp_recs, state, host_inputs = _scheduled(
                gm, seq, plan_c, profile, cfg, batch, n_state,
                "tensile+compressed-offload", check_comp, base, exact=True)
    finally:
        tensile_executor.quantize_blocked = oq.quantize_blocked
    launches = {"quantize_blocked": oq.quantize_blocked.launches,
                "dequantize_blocked": oq.dequantize_blocked.launches}
    # one launch per compressed swap, and nothing else launches them
    per_swap = {"quantize_blocked": launches["quantize_blocked"]
                / max(swaps["out_compressed"], 1),
                "dequantize_blocked": launches["dequantize_blocked"]
                / max(swaps["in_compressed"], 1)}
    log(f"[tensile] main-path launches {launches}; executor host copies "
        f"and fetches {dict(swaps)}; launches per compressed swap "
        f"{per_swap}; quantized shapes "
        f"{ {str(k): v for k, v in shapes.items()} }")

    # ---- one more compressed iteration under the profiler -------------
    ex = FxExecutor(gm, seq, plan_c, async_swap=True,
                    host_resident_inputs=host_inputs,
                    engine=MemoryEngine(profile))
    box = [state]
    del state
    prof_swaps = collections.Counter()
    with counting_swaps(prof_swaps):
        prof = profile_window(lambda: box.append(ex.run_donated(box.pop())),
                              names=PROFILED_SWAP_NAMES)
    prof["swaps"] = dict(prof_swaps)
    # host-to-card copies the graph makes itself (host constants moved to
    # the card), beside the swaps' in the profiled step's count
    prof["graph_host_to_card_copies"] = sum(
        1 for n in gm.graph.nodes
        if n.target is torch.ops.aten._to_copy.default
        and n.args[0].meta["val"].device.type == "cpu"
        and n.meta["val"].device.type == "cuda")
    del ex, box
    torch.cuda.empty_cache()

    comp_kinds = collections.Counter(
        seq.tensors[e.tensor_id].kind.value for e in plan_c.events
        if e.compressed and e.event_type.value == "swap_out")
    t_unsched = unsched[1]["wall_s"]
    t_sched = statistics.median(r["wall_s"] for r in comp_recs[1:])
    alloc_u = unsched[1]["max_memory_allocated"]
    alloc_s = max(r["max_memory_allocated"] for r in comp_recs)
    out = {
        "operators": len(seq.operators), "tensors": len(seq.tensors),
        "capture_s": capture_s, "budget": budget,
        "budget_fraction": budget / unsched_peak,
        "planned_unscheduled_peak": unsched_peak,
        "predicted_peak": res_c.final_report.peak_bytes,
        "tensile_predicted_peak": res_t.final_report.peak_bytes,
        "predicted_MSR": 1 - res_c.final_report.peak_bytes / unsched_peak,
        "measured_MSR": 1 - alloc_s / alloc_u,
        "simulated_EOR": sim["compressed"]["EOR"],
        "analytic_iteration_s": analytic_s,
        "measured_iteration_s": seq.iteration_time,
        "unscheduled_step_s": t_unsched, "scheduled_step_s": t_sched,
        "measured_EOR": t_sched / t_unsched - 1,
        "planning_s": plan_s, "planner_iterations": res_c.iterations,
        "plan_events": _event_counts(seq, plan_c),
        "compressed_swap_out_kinds": dict(comp_kinds),
        "loss_op": loss_op, "forward_compressed_reads": len(fwd_reads),
        "unscheduled": unsched, "tensile": plain_recs,
        "compressed": comp_recs, "launches": launches,
        "swaps": dict(swaps), "launches_per_swap": per_swap,
        "quantized_shapes": {str(k): v for k, v in shapes.items()},
        "profile": prof}
    log("[tensile_train] " + json.dumps(
        {k: v for k, v in out.items()
         if k not in ("tensile", "compressed")}))
    out["quantized_shapes_raw"] = dict(shapes)
    for r in comp_recs:
        gap = abs(r["max_memory_allocated"] / r["ledger_peak"] - 1)
        if gap > ALLOC_LEDGER_TOL:
            raise AssertionError(
                f"iteration {r['iteration']}: allocator peak "
                f"{r['max_memory_allocated']} B is {gap:.2%} off the ledger "
                f"peak {r['ledger_peak']} B")
        if r["max_memory_allocated"] >= alloc_u:
            raise AssertionError("the scheduled run's allocator peak is not "
                                 "below the unscheduled run's")
        fails = _update_failures(r["update_vs_exact_step"])
        if not r["loss_rel_diff"] <= COMPRESSED_TOL["loss"]:
            fails.append(f"loss: {r['loss_rel_diff']} > "
                         f"{COMPRESSED_TOL['loss']}")
        if fails:
            raise AssertionError(f"compressed plan, iteration "
                                 f"{r['iteration']}: {fails}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        if per_swap[name] != 1:
            raise AssertionError(f"{name}: {n} launches for {dict(swaps)} "
                                 "compressed swaps, not one each")
    # the profiled step copies to the host only plain swaps' tensors (the
    # graph itself copies nothing there), and to the card only plain
    # swaps', packed buffers above the zero-copy size and the graph's own
    # host constants: a trace that lost events counts fewer, a copy of
    # int8 rows or scales more
    for copy, allowed in (
            ("Memcpy DtoH", prof_swaps["out_plain"]),
            ("Memcpy HtoD", prof_swaps["in_plain"]
             + prof_swaps["in_compressed_copied"]
             + prof["graph_host_to_card_copies"])):
        if prof["named"][copy][0] > allowed:
            raise AssertionError(f"the profiled compressed step made "
                                 f"{prof['named'][copy][0]} {copy} copies "
                                 f"for {dict(prof_swaps)} swaps")
    return out


# ----------------------------------------------------------------------
# the multi-job runtime
# ----------------------------------------------------------------------
def deterministic() -> None:
    """Deterministic numerics, set before the first CUDA call."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


def full_width_serving(sp):
    """The serve job's factory: the serve phase's engine (TinyLlama at
    published width on the card; the builtin ``"lm"`` workload is
    reduced) and the named trace."""
    eng = ServingEngine(sp.arch, reduced=False,
                        max_sequences=sp.max_sequences,
                        max_len=sp.prompt_len + sp.gen_len, seed=sp.seed,
                        device="cuda")
    reqs = make_trace(sp.trace, sp.n_requests, seed=sp.seed,
                      prompt_len=sp.prompt_len, gen_len=sp.gen_len,
                      mean_gap=sp.mean_gap)
    return eng, reqs


def serve_params() -> ServeParams:
    """The serve cell as a serve job: 4 slots, prompt 16, gen 16, 8
    ``poisson`` requests, seed 0."""
    return ServeParams(arch=ARCH, max_sequences=MAX_SEQUENCES,
                       n_requests=N_REQUESTS, prompt_len=PROMPT_LEN,
                       gen_len=GEN_LEN, trace="poisson", seed=0,
                       block_tokens=4)


def train_workload(cfg, api, step, device: str = "cuda"):
    """The train jobs' factory: ``tensile_train``'s step (no remat) on a
    fresh state, parameters from a generator on ``device`` seeded
    ``seed``, zero AdamW moments, a fixed batch of ``batch`` x TRAIN_S
    tokens."""
    def make(batch: int, seed: int):
        params = dict(get_model(cfg, device).init(
            torch.Generator(device=device).manual_seed(seed))
            .named_parameters())
        data = api.input_specs(ShapeSpec(f"multi_{seed}", TRAIN_S, batch,
                                         "train"), abstract=False, seed=seed)
        return step, params, adamw_init(params), data
    return make


def host_peak_bytes() -> int:
    """This process's peak resident host memory."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def busy_ms(events) -> float:
    """Milliseconds in which at least one of ``events`` ran (the union of
    their spans: kernels of concurrent streams overlap)."""
    total, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def _solo(gm, seq, profile, spec, iters: int, measure: bool = False,
          against=None) -> dict:
    """The job alone and unscheduled from a fresh state of its seed:
    ``iters`` iterations, with ``measure`` the first synchronised per
    operator (its latencies, as ``tensile_train`` measures them); wall
    seconds, ledger and allocator peaks (net of what the card held before
    the state).  With ``against`` (the leaves of the parameters and
    moments another run reached), the positions of the leaves that differ
    from this run's final ones, compared where each of ``against`` lies
    (a leaf parked on the host against a host copy of this run's): no
    host copy of a whole state is made."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    _, params, opt, batch = resolve_workload(spec)
    n_state = len(pytree.tree_leaves([params, opt]))
    batch_leaves = pytree.tree_leaves(batch)
    state = pytree.tree_leaves([params, opt]) + batch_leaves
    del params, opt
    recs, latencies = [], None
    for k in range(iters):
        sync = measure and k == 0
        ex = FxExecutor(gm, seq, None, engine=MemoryEngine(profile),
                        measure_latency=sync)
        outs, wall, alloc, ledger = _run_state(ex, state, base)
        if sync:
            latencies = ex.stats.op_latencies
        recs.append({"wall_s": wall, "max_memory_allocated": alloc,
                     "ledger_peak": ledger, "synchronised": sync})
        state = outs[:n_state] + batch_leaves
        del ex, outs
    out = {"iterations": recs, "latencies": latencies}
    if against is not None:
        out["leaves"] = n_state
        out["differ"] = [i for i, (x, y) in enumerate(zip(against, state))
                         if len(against) != n_state
                         or not torch.equal(x, y.to(x.device))]
    del state
    torch.cuda.empty_cache()
    return out


def shared_copy_stream_cost(reps: int = 10) -> dict:
    """What one copy stream for every job costs a transfer: job X's
    swap-out (64 MiB card to pinned host) waits on X's compute stream (four
    bf16 8192^3 products) before it starts; job Y's prefetch (64 MiB pinned
    host to card) is ready at once.  Y's latency from its issue to its
    end, CUDA events, median of ``reps``, with Y's copy queued on X's copy
    stream (shared) and on a stream of its own (separate), in turns."""
    dev = torch.device("cuda")
    a = torch.randn(8192, 8192, dtype=torch.bfloat16, device=dev)
    n = 64 << 20
    x_src = torch.empty(n, dtype=torch.uint8, device=dev)
    x_dst = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    y_src = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    y_dst = torch.empty(n, dtype=torch.uint8, device=dev)
    x_compute, y_compute = torch.cuda.Stream(), torch.cuda.Stream()
    copy_x, copy_y = torch.cuda.Stream(), torch.cuda.Stream()

    def once(shared: bool) -> tuple:
        torch.cuda.synchronize()
        with torch.cuda.stream(x_compute):
            c0 = torch.cuda.Event(enable_timing=True)
            c0.record()
            for _ in range(4):
                a @ a
            ready_x = x_compute.record_event(
                torch.cuda.Event(enable_timing=True))
        t0 = y_compute.record_event(torch.cuda.Event(enable_timing=True))
        copy_x.wait_event(ready_x)
        with torch.cuda.stream(copy_x):
            x_dst.copy_(x_src, non_blocking=True)
        cy = copy_x if shared else copy_y
        cy.wait_event(t0)
        with torch.cuda.stream(cy):
            y_dst.copy_(y_src, non_blocking=True)
            t1 = cy.record_event(torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        return t0.elapsed_time(t1), c0.elapsed_time(ready_x)

    for shared in (True, False):
        once(shared)
    runs = {True: [], False: []}
    compute = []
    for r in range(reps):
        for shared in ((True, False) if r % 2 == 0 else (False, True)):
            ms, c = once(shared)
            runs[shared].append(ms)
            compute.append(c)
    out = {"shared_ms": statistics.median(runs[True]),
           "separate_ms": statistics.median(runs[False]),
           "x_compute_ms": statistics.median(compute)}
    out["wait_ms"] = out["shared_ms"] - out["separate_ms"]
    log("[multi_job] one copy stream, a prefetch behind another job's "
        "gated swap-out: " + json.dumps(out))
    return out


def multi_job(link: dict) -> dict:
    """The multi-job runtime at full width (see the module docstring):
    returns the controller's record, the hot-swap phase's and the shared
    copy stream's cost.  Runs in a fresh process (``in_fresh_process``):
    its profile of a concurrent window loses no events to earlier
    phases."""
    deterministic()
    cfg = dataclasses.replace(get_config(ARCH), remat="none",
                              n_layers=CONTROLLER_LAYERS)
    api = get_model(cfg, "cuda")
    step = build_functional_train_step(api, TrainStepConfig())
    register_workload(TRAIN_WORKLOAD, train_workload(cfg, api, step))
    register_serve_workload(SERVE_WORKLOAD, full_width_serving)
    calib = calibrate_cuda()
    profile = MachineProfile(host_link_bw=link["host_link_bw"],
                             host_link_latency=link["host_link_latency"],
                             dma_batch_overhead=link["dma_batch_overhead"])
    gc = GlobalController(
        profile=profile, cost_model=CostModel(calib), async_swap=True,
        pipeline_name=MULTI_PIPELINE, arbiter_policy="priority",
        arbiter_mode="preempt",
        scheduler_config=SchedulerConfig(patience_iters=PLAN_PATIENCE))
    specs = {j: JobSpec(j, workload=TRAIN_WORKLOAD, iterations=it,
                        workload_params={"batch": b, "seed": seed})
             for j, (b, it, seed) in MULTI_JOBS.items()}
    specs["S"] = JobSpec("S", kind="serve", workload=SERVE_WORKLOAD,
                         serve=serve_params())
    caps = {"S": timed("multi_job capture S", gc.capture_spec, specs["S"])}
    eng, reqs = caps["S"].args
    t0 = time.perf_counter()
    gold_rep, golden = eng.serve(reqs, budget_bytes=None, schedule=False)
    torch.cuda.synchronize()
    gold_s = time.perf_counter() - t0
    # what the card holds before the train states: the serve engine's
    # weights and cache, which its ledger does not book
    base = torch.cuda.memory_allocated()
    for j in MULTI_JOBS:
        caps[j] = timed(f"multi_job capture {j}", gc.capture_spec, specs[j])
    # each job's operator latencies from one synchronised unscheduled
    # iteration alone, from a fresh state of its seed
    measured, planned, demand = {}, {}, {}
    for j in MULTI_JOBS:
        seq, gm = caps[j].seq, caps[j].graph_module
        measured[j] = timed(f"multi_job latencies {j}", _solo, gm, seq,
                            profile, specs[j], 1, True)
        analytic_s = seq.iteration_time
        seq.set_latencies(measured[j].pop("latencies"))
        planned[j] = simulate([seq], None, profile, iterations=1,
                              transfer_mode="sync").peak_bytes
        demand[j] = analyze([seq], free_at_last_use=False).peak_bytes
        log(f"[multi_job] {j}: {len(seq.operators)} operators; alone, "
            f"synchronised per operator "
            f"{json.dumps(measured[j]['iterations'])}; iteration time "
            f"analytic {analytic_s:.4f} s, measured per operator "
            f"{seq.iteration_time:.4f} s; planned peak {planned[j]} B, "
            f"no-free peak {demand[j]} B")
    demand["S"] = analyze([caps["S"].seq], free_at_last_use=False).peak_bytes
    # each job's slice with all three live, as priorities of the
    # priority policy: the capacity is their sum
    target = {j: int(MULTI_SLICE * planned[j]) for j in MULTI_JOBS}
    target["S"] = int(MULTI_SERVE_SLICE * demand["S"])
    capacity = sum(target.values())
    gc.arbiter.capacity = gc.accountant.capacity = capacity
    specs = {j: dataclasses.replace(sp, priority=target[j] / 1e9)
             for j, sp in specs.items()}
    probe = BudgetArbiter(capacity, policy="priority")
    for j in specs:
        probe.register(j, priority=target[j] / 1e9, demand_bytes=demand[j])
    split = probe.split(list(specs))
    shares = {j: split[j] / planned[j] for j in MULTI_JOBS}
    shares["S"] = split["S"] / demand["S"]
    log(f"[multi_job] capacity {capacity} B; three-way split {split}; "
        f"shares of the planned peaks (S: of its KV demand) "
        f"{json.dumps(shares)}")
    if not all(0.75 <= shares[j] <= 0.85 for j in MULTI_JOBS) \
            or not shares["S"] < 1:
        raise AssertionError(f"the split {shares} misses 0.75-0.85")

    # ---- the controller's window: A, then B while A is mid-iteration,
    # then S; the KV kernels' counts from 0 ------------------------------
    kbc.kv_block_gather.launches = 0
    kbc.kv_block_scatter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    handles = {"A": gc.submit(specs["A"], caps.pop("A"))}
    a = handles["A"]
    while a.executor is None or a.executor.current_op_index <= 0:
        if a.done:
            break
        time.sleep(0.001)
    a_op = a.executor.current_op_index if a.executor is not None else None
    handles["B"] = gc.submit(specs["B"], caps.pop("B"))
    handles["S"] = gc.submit(specs["S"], caps.pop("S"))
    submitted_s = time.perf_counter() - t_start
    done_at = {}
    # the allocator against the ledger, sampled by this thread: at the
    # allocator's highest sample, and the largest gap between them
    mem = {"samples": 0, "alloc_max": 0, "ledger_then": 0, "t": None,
           "gap_max": 0, "gap_t": None, "ledger_max": 0,
           "gap_max_all_started": 0}

    def held() -> dict:
        """Per running train job: the bytes of the distinct storages its
        executor's store holds against the ledger's booking, and of the
        swap-outs still on the wire whose value left the store."""
        out = {}
        for j, h in handles.items():
            ex = h.executor
            if j not in MULTI_JOBS or ex is None:
                continue
            seen = {}
            for v in list(ex.device.values()):
                st = v.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
            pending = [rec[2] for st, rec in list(ex._pending_out.items())
                       if ex.device.get(st) is not rec[2]]
            out[j] = {"store": sum(seen.values()),
                      "booked": gc.accountant.job_bytes(j),
                      "pending_out_off_store": len(pending),
                      "pending_out_off_store_bytes": sum(
                          v.untyped_storage().nbytes() for v in pending),
                      "op": ex.current_op_index}
        return out

    def poll():
        for j, h in handles.items():
            if h.done and j not in done_at:
                done_at[j] = time.perf_counter() - t_start
        now = time.perf_counter() - t_start
        used = torch.cuda.memory_allocated() - base
        booked = gc.accountant.used
        mem["samples"] += 1
        mem["ledger_max"] = max(mem["ledger_max"], booked)
        if used > mem["alloc_max"]:
            mem.update(alloc_max=used, ledger_then=booked, t=now,
                       held_then=held())
        if used - booked > mem["gap_max"]:
            mem.update(gap_max=used - booked, gap_t=now)
        if now > submitted_s + 2 \
                and used - booked > mem["gap_max_all_started"]:
            mem.update(gap_max_all_started=used - booked,
                       gap_all_started_t=now, held_at_gap=held())
        time.sleep(0.005)

    # one profiled concurrent iteration: A's next whole one.  A weak
    # reference: an executor kept alive here would keep the tensors its
    # store held when later iterations free them
    ex0 = weakref.ref(a.executor)
    while a.executor is ex0() and not a.done:
        poll()
    window = {"profiled": not a.done}
    if not a.done:
        from torch.profiler import ProfilerActivity
        live = [j for j, h in handles.items() if not h.done]
        n_a = len(a.step_times)
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t_prof = time.perf_counter()
        while len(a.step_times) == n_a and not a.done:
            poll()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t_prof) * 1e3
        prof.stop()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        copies = [e for e in events if "Memcpy" in e.name]
        window.update({
            "a_iteration": n_a + 1, "wall_ms": prof_wall_ms,
            "device_events": len(events), "device_busy_ms": busy_ms(events),
            "kernel_ms_summed": sum(e.time_range.elapsed_us()
                                    for e in events) / 1e3,
            "copies": len(copies), "copy_busy_ms": busy_ms(copies),
            "live_at_start": live,
            "live_at_end": [j for j, h in handles.items() if not h.done]})
        window["device_idle_share"] = (1 - window["device_busy_ms"]
                                       / prof_wall_ms)
        del prof, events, copies
    log("[multi_job] profiled window (one iteration of A): "
        + json.dumps(window))
    deadline = time.perf_counter() + 900
    while len(done_at) < len(handles) and time.perf_counter() < deadline:
        poll()
    gc.wait(timeout=60)
    window_s = time.perf_counter() - t_start
    if not all(h.done for h in handles.values()):
        raise AssertionError(f"multi_job: jobs still running after "
                             f"{window_s:.0f} s: {done_at}")
    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated() - base
    launches = {"kv_block_gather": kbc.kv_block_gather.launches,
                "kv_block_scatter": kbc.kv_block_scatter.launches}

    # the same iterations alone and unscheduled, from the same state,
    # compared leaf by leaf with what each job reached
    solo = {j: timed(f"multi_job solo {j}", _solo, handles[j].graph_module,
                     handles[j].seq, profile, specs[j], it, False,
                     pytree.tree_leaves(handles[j].args[:2]))
            for j, (_, it, _) in MULTI_JOBS.items()}
    jobs = {}
    for j, h in handles.items():
        rec = {"step_s": h.step_times, "ledger_peak": gc.accountant.job_peak(j),
               "slice_final": h.budget_bytes,
               "preemptions": h.preemptions, "plan_version": h.plan_version}
        if j in MULTI_JOBS:
            solo_s = [r["wall_s"] for r in solo[j]["iterations"]]
            solo_peak = solo[j]["iterations"][0]["ledger_peak"]
            rec.update({
                "solo_step_s": solo_s,
                "solo_synchronised_step_s":
                    measured[j]["iterations"][0]["wall_s"],
                "solo_ledger_peak": solo_peak,
                "solo_max_memory_allocated":
                    solo[j]["iterations"][0]["max_memory_allocated"],
                "differing_leaves": solo[j]["differ"],
                "planned_peak": planned[j],
                "plan_predicted_peak": h.plan.planned_peak_bytes
                if h.plan is not None else None,
                "measured_MSR": 1 - rec["ledger_peak"] / solo_peak,
                "measured_EOR": statistics.median(h.step_times)
                / statistics.median(solo_s) - 1,
                "executors": [{
                    "hot_swaps": st.hot_swaps,
                    "canceled_swap_ins": st.canceled_swap_ins,
                    "swap_outs": st.swap_out_count,
                    "swap_ins": st.swap_in_count,
                    "passive_swap_ins": st.passive_swap_ins,
                    "recomputes": st.recompute_count,
                    "peak_bytes": st.peak_bytes} for st in h.stats]})
        else:
            rep = h.stats[-1]
            rec.update({"wall_s": rep.total_time, "served": rep.served,
                        "tokens": rep.tokens_generated,
                        "oom_events": rep.oom_events,
                        "evictions": rep.evictions,
                        "prefetches": rep.prefetches,
                        "peak_bytes": rep.peak_bytes,
                        "golden_wall_s": gold_s})
        jobs[j] = rec
        log(f"[multi_job] job {j}: " + json.dumps(rec))
    out = {"capacity": capacity, "shares": shares, "split": split,
           "history": gc.arbiter.history,
           "replan_count": gc.replan_count,
           "replan_s": gc.replan_seconds,
           "preempt_count": gc.preempt_count,
           "replan_failures": [repr(e) for e in gc.replan_failures],
           "preempt_failures": [repr(e) for e in gc.preempt_failures],
           "a_op_at_b_submit": a_op, "submits_s": submitted_s,
           "done_at_s": done_at, "window_s": window_s,
           "sampled_memory": mem, "global_ledger_peak": gc.global_peak_bytes,
           "ledger_oom_events": gc.accountant.oom_events,
           "max_memory_allocated": alloc,
           "alloc_over_capacity": alloc / capacity,
           "alloc_over_ledger_peak": alloc / gc.global_peak_bytes,
           "launches": launches, "profile": window, "jobs": jobs,
           "host_peak_bytes": host_peak_bytes(), "golden_S": golden,
           "demand_S": demand["S"]}
    log("[multi_job] " + json.dumps({k: v for k, v in out.items()
                                      if k not in ("jobs", "golden_S")}))

    # ---- gates ---------------------------------------------------------
    bad = []
    if gc.replan_failures or gc.preempt_failures:
        bad.append("replan or preempt failures")
    for j in MULTI_JOBS:
        if solo[j]["differ"]:
            bad.append(f"{j}: {len(solo[j]['differ'])} of "
                       f"{solo[j]['leaves']} state leaves differ from the "
                       "job run alone and unscheduled")
    if gc.global_peak_bytes > capacity:
        bad.append(f"global ledger peak {gc.global_peak_bytes} > capacity "
                   f"{capacity}")
    if alloc > (1 + ALLOC_LEDGER_TOL) * capacity:
        bad.append(f"max_memory_allocated {alloc} > 1.05 x {capacity}")
    s = handles["S"]
    if s.outputs != golden:
        bad.append("the serve job's tokens differ from the golden run")
    if jobs["S"]["oom_events"] or jobs["S"]["evictions"] <= 0:
        bad.append(f"serve: oom_events {jobs['S']['oom_events']}, "
                   f"evictions {jobs['S']['evictions']}")
    if min(launches.values()) <= 0:
        bad.append(f"KV kernel launches {launches}")
    if bad:
        raise AssertionError(f"multi_job: {bad}")
    log(f"[multi_job] gates hold: both train jobs bit-identical to their "
        f"solo runs, global ledger peak {gc.global_peak_bytes} <= "
        f"{capacity}, allocator {alloc} B, serve tokens == golden, KV "
        f"launches {launches}")

    seq_a, gm_a = handles["A"].seq, handles["A"].graph_module
    for h in handles.values():
        h.args = None
    del handles, a, s, eng, gc
    torch.cuda.empty_cache()
    hot = timed("hot_swap_full_width", hot_swap_full_width, gm_a, seq_a,
                profile, specs["A"], planned["A"])
    cost = timed("shared_copy_stream_cost", shared_copy_stream_cost)
    return {"multi_job": out, "hot_swap": hot, "copy_stream": cost}


def hot_swap_full_width(gm, seq, profile, spec, planned_peak: int) -> dict:
    """Job A's step alone in one executor, async swaps on the card,
    starting with an empty plan; ``request_plan`` hands it the plan
    ``replan_from`` builds at its first safe point after op 0 for a slice
    of HOT_SWAP_SLICE of its planned peak (``tests/test_hotswap.py``).
    Gates: one hot-swap, to that plan; swap-outs; the outputs bit-identical
    to the unscheduled step from the same state."""
    torch.cuda.synchronize()
    want = FxExecutor(gm, seq, None, engine=MemoryEngine(
        profile)).run_donated(list(resolve_workload(spec)[1:]))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    prior = SchedulingPlan(job_id=seq.job_id)
    safe = find_safe_points(seq, prior)
    first = next(sp for sp in safe if sp.op_idx > 0)
    budget = int(HOT_SWAP_SLICE * planned_peak)
    pipe = build_pipeline(MULTI_PIPELINE, profile, SchedulerConfig(
        patience_iters=PLAN_PATIENCE))
    t0 = time.perf_counter()
    newp = pipe.replan_from([seq], {seq.job_id: prior},
                            {seq.job_id: first.op_idx},
                            budgets={seq.job_id: budget}).plans[seq.job_id]
    replan_s = time.perf_counter() - t0
    ex = FxExecutor(gm, seq, prior, async_swap=True,
                    engine=MemoryEngine(profile))
    ex.request_plan(newp, {sp.op_idx for sp in safe
                           if sp.op_idx >= first.op_idx})
    outs, wall, alloc, ledger = _run_state(
        ex, list(resolve_workload(spec)[1:]), base)
    same = len(outs) == len(want) and all(
        torch.equal(a, b.to(a.device)) for a, b in zip(outs, want))
    out = {"safe_points": len(safe), "splice_op": first.op_idx,
           "budget": budget, "planned_peak": planned_peak,
           "plan_events": _event_counts(seq, newp),
           "plan_predicted_peak": newp.planned_peak_bytes,
           "replan_from_s": replan_s, "wall_s": wall,
           "max_memory_allocated": alloc, "ledger_peak": ledger,
           "hot_swaps": ex.stats.hot_swaps,
           "canceled_swap_ins": ex.stats.canceled_swap_ins,
           "swap_outs": ex.stats.swap_out_count,
           "swap_ins": ex.stats.swap_in_count,
           "recomputes": ex.stats.recompute_count,
           "bit_identical_to_unscheduled": same}
    log("[hot_swap_full_width] " + json.dumps(out))
    if ex.stats.hot_swaps != 1 or ex.plan is not newp \
            or ex.stats.swap_out_count <= 0 or not same:
        raise AssertionError(f"hot_swap_full_width: {out}")
    return out


def _experience_env(link: dict, device: str = "cuda", cfg=None):
    """What both experience phases share: the train workload registered
    as ``multi_job`` registers it, A's and B's specs, and the card's
    profile from the parent's one link measurement (``device_identity``
    salts every fingerprint with the link rate, so both processes must
    build the same profile)."""
    if device == "cuda":
        deterministic()
    cfg = cfg or dataclasses.replace(get_config(ARCH), remat="none")
    api = get_model(cfg, device)
    step = build_functional_train_step(api, TrainStepConfig())
    register_workload(TRAIN_WORKLOAD, train_workload(cfg, api, step, device))
    profile = MachineProfile(host_link_bw=link["host_link_bw"],
                             host_link_latency=link["host_link_latency"],
                             dma_batch_overhead=link["dma_batch_overhead"])
    specs = {j: JobSpec(j, workload=TRAIN_WORKLOAD, iterations=it,
                        workload_params={"batch": b, "seed": seed})
             for j, (b, it, seed) in EXPERIENCE_JOBS.items()}
    return profile, specs


class TimedStore(ExperienceStore):
    """The experience store, with the seconds of each ``record_job`` and
    ``flush`` (the controller makes both under its lock)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seconds = {"record_job": [], "flush": []}

    def record_job(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return super().record_job(*args, **kw)
        finally:
            self.seconds["record_job"].append(time.perf_counter() - t0)

    def flush(self):
        t0 = time.perf_counter()
        try:
            return super().flush()
        finally:
            self.seconds["flush"].append(time.perf_counter() - t0)


def _experience_controller(profile, store_dir: str, device: str = "cuda",
                           **kw):
    """A controller over the store at ``store_dir`` (the store
    ``experience_dir`` would make, built here so the drift monitor writes
    into it), with a drift monitor, as ``multi_job``'s: ``tensile+
    autoscale``, async swaps, the ``priority`` policy, PLAN_PATIENCE; and
    each job held to its slice (``hold_slices``: the cold plans of this
    width can exceed it, PERF.md)."""
    events = EventLog()
    store = TimedStore(store_dir, device_id=device_identity(profile))
    drift = DriftMonitor(experience=store, metrics=MetricsRegistry(),
                         events=events)
    return GlobalController(
        profile=profile, async_swap=True, pipeline_name=MULTI_PIPELINE,
        arbiter_policy="priority", experience=store, events=events,
        drift=drift, device=device, hold_slices=True,
        scheduler_config=SchedulerConfig(patience_iters=PLAN_PATIENCE),
        **kw)


def _allocated(device: str) -> int:
    if device != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _plan_record(plan) -> dict:
    kinds = collections.Counter(ev.event_type.value for ev in plan.events)
    return {"events": len(plan.events), "kinds": dict(kinds),
            "compressed": sum(bool(ev.compressed) for ev in plan.events),
            "planned_peak": plan.planned_peak_bytes,
            "budget": plan.budget_bytes,
            "warm_boot": [dict(p) for p in plan.provenance
                          if p.get("action") == "warm-boot"]}


def state_digest(state) -> str:
    """sha256 over every leaf of ``state`` (shape, dtype, then the bytes,
    copied to the host one leaf at a time), wherever each leaf lies."""
    h = hashlib.sha256()
    for t in pytree.tree_leaves(state):
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _experience_job(gc, spec, device: str, capacity=None) -> tuple:
    """One train job alone under ``gc``: captured, its peak predicted, its
    capacity (default EXPERIENCE_SLICE of the planned peak of its capture)
    set, submitted and waited for.  Returns the record and the handle."""
    base = _allocated(device)
    t0 = time.perf_counter()
    cap = gc.capture_spec(spec)
    capture_s = time.perf_counter() - t0
    seq = cap.seq
    # the capture's timeline (the run folds measured latencies into it)
    iteration_s = seq.iteration_time
    # the store's fingerprint is cached per sequence: an uncached one under
    # another salt costs what a first lookup or flush pays
    t0 = time.perf_counter()
    fingerprint(seq, device_id="uncached")
    fingerprint_s = time.perf_counter() - t0
    predicted = gc.predict_peak(seq)
    planned = simulate([seq], None, gc.profile, iterations=1,
                       transfer_mode="sync").peak_bytes
    capacity = capacity or int(EXPERIENCE_SLICE * planned)
    gc.arbiter.capacity = gc.accountant.capacity = capacity
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = gc.submit(spec, cap)
    submit_s = time.perf_counter() - t0
    del cap
    first = _plan_record(h.plan)
    gc.wait(timeout=900)
    run_s = time.perf_counter() - t0
    alloc = (torch.cuda.max_memory_allocated() - base
             if device == "cuda" else 0)
    measured = max(h.peak_bytes, gc.accountant.job_peak(spec.job_id))
    sample = gc.drift.last(h.fingerprint)
    rec = {
        "job": spec.job_id, "fingerprint": h.fingerprint,
        "operators": len(seq.operators), "capture_s": capture_s,
        "iteration_s": iteration_s,
        "measured_timeline_s": seq.iteration_time,
        "fingerprint_s": fingerprint_s, "predicted": list(predicted),
        "planned_peak": planned,
        "no_free_peak": analyze([seq], free_at_last_use=False).peak_bytes,
        "capacity": capacity, "submit_s": submit_s,
        "first_plan_s": gc.replan_seconds[0],
        "replan_s": gc.replan_seconds, "first_plan": first,
        "final_plan": _plan_record(h.plan), "plan_version": h.plan_version,
        "step_s": h.step_times, "run_s": run_s,
        "executors": [{"swap_outs": st.swap_out_count,
                       "budget_waits": st.budget_waits,
                       "budget_wait_s": st.budget_wait_s,
                       "budget_evictions": st.budget_evictions,
                       "swap_ins": st.swap_in_count,
                       "passive_swap_ins": st.passive_swap_ins,
                       "recomputes": st.recompute_count,
                       "compressed_swaps": st.compressed_swaps,
                       "hot_swaps": st.hot_swaps,
                       "peak_bytes": st.peak_bytes} for st in h.stats],
        "measured_peak": measured,
        "stored": list(gc.experience.predicted_peak(seq) or ()),
        "global_ledger_peak": gc.global_peak_bytes,
        "max_memory_allocated": alloc,
        "drift": dataclasses.asdict(sample) if sample else None,
        "store_seconds": gc.experience.seconds,
        "warnings": [(e.source, e.message) for e in gc.events.warnings()],
        "experience_failures": [repr(e) for _, e in gc.experience_failures],
        "error": repr(h.error) if h.error else None}
    log(f"[experience] job {spec.job_id}: " + json.dumps(rec, default=str))
    return rec, h


def _experience_gates(rec: dict, prior_peak: int = 0) -> list:
    """The gates every experience run holds (``multi_job``'s memory gates
    among them); the store keeps the largest peak measured so far
    (``prior_peak`` before this run)."""
    bad = []
    j = rec["job"]
    if rec["error"] or rec["experience_failures"]:
        bad.append(f"{j}: error {rec['error']}, experience failures "
                   f"{rec['experience_failures']}")
    if rec["first_plan"]["compressed"] or rec["final_plan"]["compressed"] \
            or any(e["compressed_swaps"] for e in rec["executors"]):
        bad.append(f"{j}: a compressed event")
    if rec["global_ledger_peak"] > rec["capacity"]:
        bad.append(f"{j}: global ledger peak {rec['global_ledger_peak']} > "
                   f"capacity {rec['capacity']}")
    if rec["max_memory_allocated"] > (1 + ALLOC_LEDGER_TOL) * rec["capacity"]:
        bad.append(f"{j}: max_memory_allocated "
                   f"{rec['max_memory_allocated']} > 1.05 x capacity")
    if rec["stored"] != [max(rec["measured_peak"], prior_peak),
                         "experience"]:
        bad.append(f"{j}: the store holds {rec['stored']}, measured "
                   f"{rec['measured_peak']}")
    return bad


def _store_bytes(store) -> int:
    return sum(os.path.getsize(os.path.join(store.dir, n))
               for n in os.listdir(store.dir))


def fit_latency_mlp(samples, util: float, device: str) -> tuple:
    """LatencyMLP (hidden 32, seed 0) on ``device``, fitted on measured
    operator samples (flops, bytes, the capture's utilisation, latency):
    a MLP_FIT split drawn from a numpy seed; train and test R², the mean
    squared error of log-latency before and after, the fit's seconds."""
    s = [x for x in samples if x.latency_s > 0]
    flops = np.array([x.flops for x in s])
    bts = np.array([x.bytes_accessed for x in s])
    lat = np.array([x.latency_s for x in s])
    u = np.full(len(s), util, dtype=np.float32)
    idx = np.random.default_rng(MLP_FIT["seed"]).permutation(len(s))
    k = int(MLP_FIT["train_share"] * len(s))
    tr, te = idx[:k], idx[k:]
    mlp = LatencyMLP(seed=0, device=device)

    def mse(rows) -> float:
        x = torch.from_numpy(LatencyMLP.featurize(
            flops[rows], bts[rows], u[rows])).to(device)
        with torch.no_grad():
            pred = mlp(x).cpu().numpy()
        return float(np.mean((pred - np.log(np.maximum(lat[rows], 1e-9)))
                             ** 2))

    loss0 = mse(tr)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2_train = mlp.fit(flops[tr], bts[tr], u[tr], lat[tr],
                       steps=MLP_FIT["steps"], lr=MLP_FIT["lr"])
    if device == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    out = {"samples": len(s), "train": len(tr), "test": len(te),
           "loss_before": loss0, "loss_after": mse(tr),
           "r2_train": r2_train,
           "r2_test": mlp.r2(flops[te], bts[te], u[te], lat[te]),
           "fit_s": fit_s, **MLP_FIT}
    log("[experience] LatencyMLP on A's measured operators: "
        + json.dumps(out))
    return out, mlp


def experience_cold(link: dict, store_dir: str, device: str = "cuda",
                    cfg=None) -> dict:
    """The store's first run (module docstring): A then B, each under a
    controller of its own over the empty store, planned from the cost
    model's latencies of a measured calibration; then the LatencyMLP on
    A's measured operators.  Runs in a fresh process."""
    profile, specs = _experience_env(link, device, cfg)
    # the card's rates, and the executor's per-operator floor as the
    # model's overhead
    calib = (dataclasses.replace(calibrate_cuda(),
                                 overhead_s=executor_floor())
             if device == "cuda" else DeviceCalibration())
    measured_calib = dataclasses.asdict(calib)
    out = {"calibration": measured_calib}
    bad = []
    gc = _experience_controller(profile, store_dir, device=device,
                                cost_model=CostModel(
                                    dataclasses.replace(calib)))
    rec_a, h = _experience_job(gc, specs["A"], device)
    out["digest_A"] = state_digest(h.args[:2])
    util = gc.cost_model.utilization
    samples = list(gc.telemetry.ops.get("A", ()))
    h.args = None
    del h
    out["A"] = rec_a
    out["store_bytes_after_A"] = _store_bytes(gc.experience)
    rec_a_stored_calib = dataclasses.asdict(
        gc.experience.device_calibration())
    # B's fingerprint is new to the store, but the card is not: with no
    # explicit cost model its controller starts from the calibration A's
    # run recalibrated and stored (the store's device record)
    gc2 = _experience_controller(profile, store_dir, device=device)
    b_calib = dataclasses.replace(gc2.cost_model.calib)
    rec_b, h = _experience_job(gc2, specs["B"], device)
    h.args = None
    del h
    out["B"] = rec_b
    out["B_calibration"] = dataclasses.asdict(b_calib)
    out["A_calibration_stored"] = rec_a_stored_calib
    out["store_bytes"] = _store_bytes(gc2.experience)
    out["stored_calibration"] = dataclasses.asdict(
        gc2.experience.device_calibration())
    out["mlp"], mlp = fit_latency_mlp(samples, util, device)
    # ---- gates ---------------------------------------------------------
    for rec in (rec_a, rec_b):
        bad += _experience_gates(rec)
        if rec["predicted"][1] != "cost-model":
            bad.append(f"{rec['job']}: cold prediction {rec['predicted']}")
    if out["B_calibration"] != out["A_calibration_stored"]:
        bad.append(f"B's cost model {out['B_calibration']} is not the "
                   f"calibration A stored {out['A_calibration_stored']}")
    d = rec_a["drift"]
    if d is None or d["peak_drift"] <= DRIFT_THRESHOLD \
            or "drift" not in {w[0] for w in rec_a["warnings"]}:
        bad.append(f"A: drift sample {d}, warnings {rec_a['warnings']}")
    m = out["mlp"]
    if not m["loss_after"] < m["loss_before"] \
            or not all(math.isfinite(m[k]) for k in ("r2_train", "r2_test")):
        bad.append(f"LatencyMLP fit: {m}")
    if bad:
        raise AssertionError(f"experience_cold: {bad}")
    out["handoff"] = {
        "fingerprints": {j: out[j]["fingerprint"] for j in ("A", "B")},
        "capacity": {j: out[j]["capacity"] for j in ("A", "B")},
        "stored_peak_A": rec_a["stored"],
        "peak_drift_A": d["peak_drift"], "digest_A": out["digest_A"]}
    log("[experience] cold gates hold: " + json.dumps(out["handoff"]))
    # the fitted predictor, for the service daemon's cost model
    out["handoff"]["mlp_state"] = {k: v.cpu().tolist()
                                   for k, v in mlp.state_dict().items()}
    return out


def experience_warm(link: dict, store_dir: str, cold: dict,
                    device: str = "cuda", cfg=None,
                    service: dict = None) -> dict:
    """The store's second run, in a new process (module docstring): a
    controller over the same store with no explicit cost model captures,
    predicts and runs A; the ``peak`` policy's split of A and B with and
    without the store's priors.  ``cold`` is ``experience_cold``'s
    handoff.  With ``service`` (``service_submit``'s), the service
    plane's daemon then runs in this process over the same store, with
    A's capture (``service_daemon``)."""
    profile, specs = _experience_env(link, device, cfg)
    gc = _experience_controller(profile, store_dir, device=device)
    store = gc.experience
    stored = store.device_calibration()
    # the warm boot, before the run recalibrates the model from the hub
    warm_calib = dataclasses.replace(gc.cost_model.calib)
    out = {"calibration": dataclasses.asdict(warm_calib),
           "stored_calibration": dataclasses.asdict(stored)
           if stored else None}
    rec, h = _experience_job(gc, specs["A"], device,
                             capacity=cold["capacity"]["A"])
    out["digest_A"] = state_digest(h.args[:2])
    seq_a, gm_a = h.seq, h.graph_module
    h.args = None
    del h
    out["A"] = rec
    fp = rec["fingerprint"]
    out["drift_history"] = [dataclasses.asdict(r)
                            for r in store.drift_history(fp)]
    # the peak policy on the host: A and B at their no-free demands, then
    # with the store's priors (the peaks their cold runs measured)
    cap_b = gc.capture_spec(specs["B"])
    seqs = {"A": seq_a, "B": cap_b.seq}
    del cap_b
    arb = BudgetArbiter(sum(cold["capacity"].values()), policy="peak")
    for j, seq in seqs.items():
        arb.register(j, demand_bytes=analyze(
            [seq], free_at_last_use=False).peak_bytes)
    split = {"no_priors": arb.split(list(seqs))}
    for j, seq in seqs.items():
        arb.set_prior(j, store.prior(seq))
    split["priors"] = arb.split(list(seqs))
    split["demands"] = dict(arb.demands)
    split["prior_peaks"] = {j: p.peak_bytes for j, p in arb.priors.items()}
    split["cold_capacity"] = cold["capacity"]
    out["peak_split"] = split
    out["bandwidth"] = {"store": store.bandwidth(),
                        "link": link["host_link_bw"]}
    out["store_bytes"] = _store_bytes(store)
    log("[experience] peak policy: " + json.dumps(split))
    log("[experience] store bandwidth " + json.dumps(out["bandwidth"]))
    # ---- gates ---------------------------------------------------------
    bad = _experience_gates(rec, cold["stored_peak_A"][0])
    if fp != cold["fingerprints"]["A"]:
        bad.append(f"A's fingerprint {fp} != cold {cold['fingerprints']}")
    if rec["predicted"] != cold["stored_peak_A"]:
        bad.append(f"warm prediction {rec['predicted']} != the cold "
                   f"measured peak {cold['stored_peak_A']}")
    if stored is None or warm_calib != stored:
        bad.append(f"cost model {out['calibration']} != stored "
                   f"{out['stored_calibration']}")
    wb = rec["first_plan"]["warm_boot"]
    if not wb or wb[-1]["verified_peak_bytes"] > rec["capacity"]:
        bad.append(f"A's first plan carries no warm boot within its "
                   f"capacity: {wb}")
    if out["digest_A"] != cold["digest_A"]:
        bad.append("A's final state differs from the cold run's")
    d = rec["drift"]
    if d is None or not d["peak_drift"] < cold["peak_drift_A"]:
        bad.append(f"warm drift {d} not below cold {cold['peak_drift_A']}")
    if len(out["drift_history"]) < 2:
        bad.append(f"drift history {out['drift_history']}")
    if bad:
        raise AssertionError(f"experience_warm: {bad}")
    log("[experience] warm gates hold: fingerprint, prediction "
        f"{rec['predicted']}, calibration, warm boot {wb[-1]}, digest, "
        f"drift {d['peak_drift']} < {cold['peak_drift_A']}")
    if service is not None:
        del gc, store
        out["service"] = timed("service_daemon", service_daemon,
                               store_dir, service, profile,
                               (seq_a, gm_a), cold["mlp_state"])
    return out


# ---------------------------------------------------------------- service
def service_submit(root: str, cold: dict, mj: dict) -> dict:
    """The service phase's client (module docstring): A, C and S and a
    drain request dropped into the inbox of ``root`` (outside the
    checkout) before any daemon runs, so the daemon's first tick captures
    and predicts all three before it admits any.  A's slice is its cold
    capacity (``cold``: ``experience_cold``'s handoff), S's half its KV
    demand, given as the specs' priorities; the daemon sets the capacity.
    ``mj`` is ``multi_job``'s result: S's KV demand from that controller's
    capture of the same serve spec, and S's unbudgeted serve (the same
    factory and trace), which the daemon's S must reproduce."""
    demand_s = mj["demand_S"]
    slices = {"A": cold["capacity"]["A"],
              "S": int(MULTI_SERVE_SLICE * demand_s)}
    a, _, seed = EXPERIENCE_JOBS["A"]
    client = ServiceClient(root)
    specs = {"A": JobSpec("A", workload=TRAIN_WORKLOAD,
                          iterations=SERVICE_A_ITERS,
                          priority=slices["A"] / 1e9,
                          workload_params={"batch": a, "seed": seed}),
             "C": JobSpec("C", workload=TRAIN_WORKLOAD, iterations=1,
                          workload_params={"batch": SERVICE_C_BATCH,
                                           "seed": 2}),
             "S": JobSpec("S", kind="serve", workload=SERVE_WORKLOAD,
                          priority=slices["S"] / 1e9, serve=serve_params())}
    for spec in specs.values():
        client.submit(spec)
    client.drain()
    return {"root": root, "slices": slices, "demand_S": demand_s,
            "golden_S": mj["golden_S"], "spec_A": specs["A"].to_dict(),
            "dropped": time.time()}


def service_gates(service: dict, cold: dict, warm: dict) -> dict:
    """The service phase's gates on what the daemon left: the store's
    records read back through the client, and the daemon process's own
    gates (``service_daemon``)."""
    client = ServiceClient(service["root"])
    records = {j: r.to_dict() for j, r in client.status().items()}
    heartbeat = client.heartbeat()
    out = dict(warm["service"])
    bad = list(out.pop("bad"))
    capacity = out["capacity"]
    states = {j: r["state"] for j, r in records.items()}
    want = {"A": "DONE", "C": "REJECTED", "S": "DONE", "crash-q": "DONE",
            "crash-a": "DONE", "crash-r": "DONE"}
    if states != want:
        bad.append(f"states {states}, not {want}")
    ra, rc_, rs = records["A"], records["C"], records["S"]
    if (ra["predicted_source"], ra["predicted_peak_bytes"]) != \
            ("experience", warm["A"]["stored"][0]):
        bad.append(f"A predicted {ra['predicted_peak_bytes']} "
                   f"[{ra['predicted_source']}], the store holds "
                   f"{warm['A']['stored']}")
    if rc_["predicted_source"] != "cost-model" \
            or rc_["predicted_peak_bytes"] <= capacity \
            or "never admissible" not in (rc_["error"] or ""):
        bad.append(f"C: {rc_}")
    # the daemon's own capture of S books the KV demand the slices were
    # drawn from
    if (rs["predicted_source"], rs["predicted_peak_bytes"]) != \
            ("cost-model", service["demand_S"]):
        bad.append(f"S predicted {rs['predicted_peak_bytes']} "
                   f"[{rs['predicted_source']}], its KV demand "
                   f"{service['demand_S']}")
    if records["crash-r"]["requeues"] != 1:
        bad.append(f"the orphan was re-queued {records['crash-r']['requeues']}"
                   " times")
    if not heartbeat or heartbeat["state"] != "stopped":
        bad.append(f"heartbeat {heartbeat}")
    out["seconds"].setdefault("A", {})["capture_reused"] = \
        warm["A"]["capture_s"]
    out.update({"slices": service["slices"], "demand_S": service["demand_S"],
                "predicted": {j: [records[j]["predicted_peak_bytes"],
                                  records[j]["predicted_source"]]
                              for j in ("A", "C", "S")},
                "cold_measured_A": cold["handoff"]["stored_peak_A"][0],
                # from the drop into the inbox: the cold and warm runs,
                # then the daemon's first tick
                "queue_wait_s": {j: records[j]["admitted_at"]
                                 - service["dropped"] for j in ("A", "S")}})
    log(f"[service] {card_line()}: " + json.dumps(out))
    if bad:
        raise AssertionError(f"service: {bad}")
    log(f"[service] gates hold: A warm from the store "
        f"({out['predicted']['A'][0]} B, experience) and bit-identical to "
        f"its solo run, C rejected cold ({out['predicted']['C'][0]} B > "
        f"{capacity} B) after a capture through the LatencyMLP "
        f"({out['mlp']['calls']} predictions, "
        f"{out['mlp']['iteration_s_C']} s an iteration), S golden with "
        f"{out['S']['evictions']} evictions, KV launches {out['launches']}, "
        "the orphan re-queued once, metrics and trace valid")
    return out


def service_daemon(store_dir: str, service: dict, profile,
                   capture_a: tuple, mlp_state: dict) -> dict:
    """The service phase's daemon (module docstring), in the
    ``experience_warm`` process after its gates: a ``SchedulerDaemon``
    over ``service["root"]`` whose controller owns the card, over the
    experience store at ``store_dir``, with a trace recorder on the daemon
    and the controller's engine, runs what the inbox holds until it
    drains; then A against its solo run, S against the golden serve, the
    metrics and the trace; then a crashed daemon's orphans recovered on
    the same root.  ``capture_a`` is the (sequence, graph module) this
    process captured for A: the daemon holds that pair and a fresh state
    as A's capture from the start, so admission captures A no second
    time.  The controller's cost model carries the LatencyMLP
    ``experience_cold`` fitted (``mlp_state``), so the captures admission
    makes (C's) predict each operator's latency through it.  The capacity
    is the two slices' sum, or what admission needs for both predicted
    peaks.  Per job, capture and prediction seconds come from the
    daemon's admission spans on the trace.  Returns the numbers and the
    gates that failed here."""
    t_phase = time.perf_counter()
    root = service["root"]
    engine_bytes, serve_s = {}, {}

    def serving(sp):
        """``full_width_serving``, with the bytes its engine holds (which
        no ledger books) and the wall seconds of its serve."""
        before = torch.cuda.memory_allocated()
        eng, reqs = full_width_serving(sp)
        engine_bytes["S"] = torch.cuda.memory_allocated() - before
        serve = eng.serve

        def timed_serve(*args, **kw):
            t0 = time.perf_counter()
            res = serve(*args, **kw)
            torch.cuda.synchronize()
            serve_s["S"] = time.perf_counter() - t0
            return res

        eng.serve = timed_serve
        return eng, reqs

    register_serve_workload(SERVE_WORKLOAD, serving)
    seq_a, gm_a = capture_a
    store = ExperienceStore(store_dir, device_id=device_identity(profile))
    capacity = max(sum(service["slices"].values()),
                   store.predicted_peak(seq_a)[0] + service["demand_S"])
    del store
    mlp = LatencyMLP(seed=0, device="cuda")
    mlp.load_state_dict({k: torch.tensor(v) for k, v in mlp_state.items()})
    mlp_calls = collections.Counter()
    mlp.register_forward_hook(lambda *_: mlp_calls.update(["forward"]))
    cost_model = CostModel(calibrate_cuda())
    cost_model.mlp = mlp
    controller = dict(
        profile=profile, cost_model=cost_model,
        async_swap=True, pipeline_name=MULTI_PIPELINE,
        arbiter_policy="priority", experience_dir=store_dir,
        hold_slices=True, device="cuda",
        scheduler_config=SchedulerConfig(patience_iters=PLAN_PATIENCE))
    daemon = SchedulerDaemon(root, capacity_bytes=capacity,
                             poll_interval=SERVICE_POLL,
                             controller_kwargs=controller)
    gc = daemon.controller
    recorder = TraceRecorder(clock="real", budget_bytes=capacity)
    daemon.attach_recorder(recorder)
    gc.engine.attach_recorder(recorder)
    kbc.kv_block_gather.launches = 0
    kbc.kv_block_scatter.launches = 0
    base = _allocated("cuda")
    torch.cuda.reset_peak_memory_stats()
    # the daemon's captures by job (``SchedulerDaemon._captured``): one it
    # holds is not captured again.  A's fresh state is made after the
    # allocator's base, which it counts against the capacity as the
    # ledger does
    _, params, opt, batch = resolve_workload(
        JobSpec.from_dict(service["spec_A"]))
    daemon._captured["A"] = CapturedJob(
        seq=seq_a, graph_module=gm_a, args=(params, opt, batch),
        fingerprint=gc.experience.fingerprint(seq_a))
    del params, opt, batch
    t0 = time.perf_counter()
    daemon.serve_forever()
    loop_s = time.perf_counter() - t0
    gc.wait(timeout=60)
    torch.cuda.synchronize()
    launches = {"kv_block_gather": kbc.kv_block_gather.launches,
                "kv_block_scatter": kbc.kv_block_scatter.launches}
    alloc = (torch.cuda.max_memory_allocated() - base
             - engine_bytes.get("S", 0))
    bad = []
    with open(daemon.metrics_path) as f:
        metrics = parse_metrics_text(f.read())
    names = {n for n, _ in metrics}
    rate = metrics.get(("tensile_serve_tokens_per_sec", (("job", "S"),)))
    if not set(SERVICE_GAUGES) <= names or not rate:
        bad.append(f"metrics.prom lacks {set(SERVICE_GAUGES) - names} "
                   f"(serve rate {rate})")
    # the trace, dumped as the daemon drained
    t1 = time.perf_counter()
    trace_path = os.path.join(root, "service.trace.json")
    trace = recorder.dump(trace_path)
    dump_s = time.perf_counter() - t1
    errors = validate_chrome_trace(trace)
    tracks = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    instants = sorted((tracks.get(e.get("tid"), ""), e["name"])
                      for e in trace["traceEvents"]
                      if e["ph"] == "i" and e["name"].startswith("job:"))
    want_instants = sorted([("job:A", f"job:{s}") for s in
                            ("ADMITTED", "RUNNING", "DONE")]
                           + [("job:S", f"job:{s}") for s in
                              ("ADMITTED", "RUNNING", "DONE")]
                           + [("job:C", "job:REJECTED")])
    # admission's spans: a capture for each job the daemon captured (A's
    # it was handed), a prediction for each
    admission = {(tracks.get(e["tid"], "")[4:], e["name"]): e
                 for e in trace["traceEvents"] if e.get("cat") == "admission"}
    seconds = collections.defaultdict(dict)
    for (j, name), e in admission.items():
        seconds[j]["prediction" if name == "predict" else name] = \
            e["dur"] / 1e6
    iteration_c = admission.get(("C", "capture"), {}).get(
        "args", {}).get("iteration_s")
    h_a, h_s = gc.jobs["A"], gc.jobs["S"]
    ops_a = sum(1 for e in trace["traceEvents"]
                if e.get("cat") == "op" and e["args"].get("job") == "A")
    dma = sum(1 for e in trace["traceEvents"]
              if e.get("cat") == "transfer" and e.get("tid") == DMA_TID)
    if errors or instants != want_instants \
            or sorted(admission) != [("A", "predict"), ("C", "capture"),
                                     ("C", "predict"), ("S", "capture"),
                                     ("S", "predict")] \
            or ops_a != SERVICE_A_ITERS * len(h_a.seq.operators) or not dma:
        bad.append(f"trace: {errors[:5]}, instants {instants}, admission "
                   f"spans {sorted(admission)}, A's op spans {ops_a} for "
                   f"{len(h_a.seq.operators)} operators, {dma} DMA spans")
    # C's capture went through the predictor: one call an operator whose
    # cost it priced, and a finite, positive iteration time
    if not mlp_calls["forward"] or iteration_c is None \
            or not (math.isfinite(iteration_c) and iteration_c > 0):
        bad.append(f"the LatencyMLP in C's capture: {mlp_calls['forward']} "
                   f"calls, iteration {iteration_c} s")
    summary = summarize_trace(trace)
    trace_out = {"events": len(trace["traceEvents"]),
                 "bytes": os.path.getsize(trace_path), "dump_s": dump_s,
                 "op_spans_A": ops_a, "dma_spans": dma,
                 "transfers": summary["transfer_count"],
                 "budget_violations": len(summary["budget_violations"])}
    del trace, summary
    rep = h_s.stats[-1]
    out = {"loop_s": loop_s, "seconds": dict(seconds),
           "first_iteration_s": {"A": h_a.step_times[0], "S": serve_s["S"]},
           "global_ledger_peak": gc.global_peak_bytes,
           "max_memory_allocated": alloc, "engine_bytes_S":
           engine_bytes["S"], "launches": launches,
           "replans": gc.replan_count, "replan_s": gc.replan_seconds,
           "split": gc.arbiter.history,
           "budget_guard": [{"waits": st.budget_waits,
                             "evictions": st.budget_evictions,
                             "swap_outs": st.swap_out_count}
                            for st in h_a.stats],
           "mlp": {"calls": mlp_calls["forward"],
                   "iteration_s_C": iteration_c},
           "S": {"tokens": rep.tokens_generated,
                 "wall_tokens_per_s": rep.tokens_generated / serve_s["S"],
                 "virtual_tokens_per_s": rep.tokens_per_s,
                 "evictions": rep.evictions, "oom_events": rep.oom_events,
                 "budget": h_s.budget_bytes, "peak_bytes": rep.peak_bytes},
           "metrics_samples": len(metrics), "trace": trace_out}
    if gc.global_peak_bytes > capacity:
        bad.append(f"global ledger peak {gc.global_peak_bytes} > capacity "
                   f"{capacity}")
    if alloc > (1 + ALLOC_LEDGER_TOL) * capacity:
        bad.append(f"max_memory_allocated {alloc} > 1.05 x {capacity}")
    if rep.oom_events or rep.evictions <= 0:
        bad.append(f"serve: oom_events {rep.oom_events}, evictions "
                   f"{rep.evictions}")
    if min(launches.values()) <= 0:
        bad.append(f"KV kernel launches {launches}")
    # A against the same iterations alone and unscheduled from the same
    # state; S against the golden serve
    tokens = h_s.outputs
    h_s.args = None
    solo = timed("service solo A", _solo, h_a.graph_module, h_a.seq, profile,
                 JobSpec("A", workload=TRAIN_WORKLOAD,
                         workload_params=h_a.spec.workload_params),
                 SERVICE_A_ITERS, False, pytree.tree_leaves(h_a.args[:2]))
    if solo["differ"]:
        bad.append(f"A: {len(solo['differ'])} of {solo['leaves']} state "
                   "leaves differ from its solo unscheduled run")
    h_a.args = None
    if tokens != service["golden_S"]:
        bad.append("the serve job's tokens differ from the golden run")
    # a crashed daemon's queue on the same root: one QUEUED, one ADMITTED
    # and one RUNNING orphan (MLP jobs), recovered by a new daemon
    now = time.time()
    store = JobStore(root)
    seeded = {"crash-q": JobState.QUEUED, "crash-a": JobState.ADMITTED,
              "crash-r": JobState.RUNNING}
    for jid, state in seeded.items():
        store.put(JobRecord(spec=JobSpec(jid, workload="mlp", iterations=1,
                                         workload_params={"size": "small"}),
                            state=state, submitted_at=now), now)
    t1 = time.perf_counter()
    again = SchedulerDaemon(root, poll_interval=SERVICE_POLL,
                            controller_kwargs={"device": "cuda"})
    recovered = again.recovered
    drained = again.drain(timeout=120)
    out["recovery"] = {"recovered": recovered, "drained": drained,
                       "s": time.perf_counter() - t1}
    if set(recovered["replayed"]) != {"crash-q", "crash-a"} \
            or recovered["requeued_orphans"] != ["crash-r"] \
            or recovered["failed_orphans"] or not drained:
        bad.append(f"recovery: {out['recovery']}")
    with open(again.metrics_path) as f:
        names = {n for n, _ in parse_metrics_text(f.read())}
    if not set(SERVICE_GAUGES[:5]) <= names:
        bad.append(f"the restarted daemon's metrics lack "
                   f"{set(SERVICE_GAUGES[:5]) - names}")
    out.update({"phase_s": time.perf_counter() - t_phase,
                "capacity": capacity, "bad": bad})
    return out


# ---------------------------------------------------------------- phase 7
def loss_and_grads(api, params, batch, policy=None) -> tuple:
    """The train step's loss and gradients (by parameter name) on
    ``params``, each block repeat checkpointed under ``policy`` (else as
    ``api.cfg.remat`` says)."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss = api.loss(params, batch, remat_policy=policy)
        grads = torch.autograd.grad(loss, list(named.values()))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    return loss.detach(), dict(zip(named, grads))


def _peak_of(fn, dev: str) -> tuple:
    """``fn()``, its seconds (synchronised) and the card's allocator peak
    over it (None on the CPU)."""
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return out, s, (torch.cuda.max_memory_allocated() if dev == "cuda"
                    else None)


def _host_leaves(*trees) -> list:
    """Host copies of every tensor of ``trees`` (of a module, its
    parameters)."""
    out = []
    for tree in trees:
        leaves = (list(tree.parameters())
                  if isinstance(tree, torch.nn.Module)
                  else pytree.tree_leaves(tree))
        out += [t.detach().to("cpu", copy=True) for t in leaves]
    return out


def _all_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def timing_checkpoints(times: dict):
    """While active, add the seconds of each checkpoint snapshot (the copy
    of the state to the host), write and restore into ``times``."""
    cls = CheckpointManager
    names = ("_snapshot", "_write", "restore")
    saved = {n: cls.__dict__[n] for n in names}

    def timed_fn(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times.setdefault(name, []).append(time.perf_counter() - t0)
        return call

    cls._snapshot = staticmethod(timed_fn("snapshot", cls._snapshot))
    cls._write = timed_fn("write", saved["_write"])
    cls.restore = timed_fn("restore", saved["restore"])
    try:
        yield times
    finally:
        for n, f in saved.items():
            setattr(cls, n, f)


def _restart_run(api, cfg, tcfg, ckpt_dir: str, dev: str, batch: int,
                 seq: int, fail_at=None) -> dict:
    """LAUNCHER_STEPS steps of the launcher's loop from a fresh state
    (weights from seed 0), data from the stream through the prefetcher,
    a checkpoint every LAUNCHER_CKPT_EVERY steps (none with ``fail_at``
    None, the uninterrupted run, beyond the final one): the loop's result,
    the state's digest, the batches each step took, the checkpoint's
    bytes and the checkpoints' seconds."""
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    opt = opt_state_for(params)
    stream = TokenStream(DataConfig(seq_len=seq, global_batch=batch,
                                    vocab_size=cfg.vocab_size))
    pf = Prefetcher(stream, to_device=to_device(dev))
    step = build_train_step(api, tcfg)
    fed, losses = [], []

    def logged(p, o, b):
        fed.append(hashlib.sha256(b["tokens"].cpu().numpy().tobytes())
                   .hexdigest()[:16])
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        return p, o, m

    times: dict = {}
    try:
        with timing_checkpoints(times):
            res = resilient_train_loop(
                logged, (params, opt), pf, LAUNCHER_STEPS,
                ft=FTConfig(ckpt_dir=ckpt_dir, keep=1, ckpt_every=(
                    LAUNCHER_CKPT_EVERY if fail_at else 0)),
                data_stream=stream, fail_at=fail_at)
    finally:
        pf.close()
    mgr = CheckpointManager(ckpt_dir, keep=1)
    d = mgr._step_dir(mgr.latest_step())
    want = [hashlib.sha256(stream.batch_at(s)["tokens"].tobytes())
            .hexdigest()[:16] for s in range(LAUNCHER_STEPS)]
    return {"restarts": res.restarts, "final_step": res.final_step,
            "digest": state_digest((dict(params.named_parameters()), opt)),
            "fed": fed,
            "stream_batches": want, "losses": losses,
            "ckpt_bytes": sum(os.path.getsize(os.path.join(d, f))
                              for f in os.listdir(d)),
            "ckpt_s": times}


def main_budget_mb(dev: str, batch: int, seq: int) -> float:
    """LAUNCHER_BUDGET of the planned peak of the step that
    ``launch.train.main`` runs at its reduced width, in MiB: the step
    without remat over int8 moments, captured as ``main`` captures it."""
    cfg = get_config(ARCH).reduced()
    params = get_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(dict(params.named_parameters()), grad_compression=True)
    probe = build_functional_train_step(
        get_model(dataclasses.replace(cfg, remat="none"), dev),
        TrainStepConfig())
    data = to_device(dev)(TokenStream(DataConfig(
        seq_len=seq, global_batch=batch,
        vocab_size=cfg.vocab_size)).batch_at(0))
    s, _ = capture_train_step(probe, dict(params.named_parameters()), opt,
                              data)
    planned = simulate([s], None, MachineProfile(), iterations=1,
                       transfer_mode="sync").peak_bytes
    return LAUNCHER_BUDGET * planned / 2**20


def train_launcher(device: str = "cuda", cfg=None, batch: int = TRAIN_B,
                   seq: int = TRAIN_S) -> dict:
    """The training launcher's path (``launch.train``) at full width on
    the card: TENSILE's decisions as a remat policy, moments on the host,
    int8 error-feedback gradients, prefetch, checkpoints and a restart,
    then ``launch.train.main`` itself.  Runs in a fresh process
    (``in_fresh_process``).  ``device``, ``cfg``, ``batch`` and ``seq``
    rehearse it on the CPU at a reduced size."""
    deterministic()
    dev = device
    cfg = cfg or dataclasses.replace(get_config(ARCH),
                                     n_layers=LAUNCHER_LAYERS)
    card = card_line() if dev == "cuda" else "cpu"
    api = get_model(cfg, dev)
    rec: dict = {"card": card}
    stream = TokenStream(DataConfig(seq_len=seq, global_batch=batch,
                                    vocab_size=cfg.vocab_size))
    data = to_device(dev)(stream.batch_at(0))

    # TENSILE's decisions: the step without remat captured on fake tensors,
    # planned at LAUNCHER_BUDGET of its planned peak
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    opt = opt_state_for(params)
    probe = build_functional_train_step(
        get_model(dataclasses.replace(cfg, remat="none"), dev),
        TrainStepConfig())
    t0 = time.perf_counter()
    seqn, _ = capture_train_step(probe, dict(params.named_parameters()),
                                 opt, data)
    capture_s = time.perf_counter() - t0
    planned = simulate([seqn], None, MachineProfile(), iterations=1,
                       transfer_mode="sync").peak_bytes
    budget = int(LAUNCHER_BUDGET * planned)
    t0 = time.perf_counter()
    decisions = schedule_for_budget(seqn, budget)
    plan_s = time.perf_counter() - t0
    rec["tensile"] = {
        "operators": len(seqn.operators), "capture_s": capture_s,
        "planned_peak": planned, "budget": budget, "plan_s": plan_s,
        "remat_names": len(decisions.remat_names),
        "offload_names": len(decisions.offload_names),
        "offload_opt_state": decisions.offload_opt_state,
        "device_peak_estimate": decisions.device_peak_estimate,
        "host_bytes_estimate": decisions.host_bytes_estimate}
    log(f"[train_launcher] decisions: {decisions.summary()[:3000]}")
    del seqn, probe
    policy = make_remat_policy(decisions)

    # the policy step against the block remat step, same state (after one
    # untimed call)
    block = get_model(dataclasses.replace(cfg, remat="block"), dev)
    loss_and_grads(block, params, data)
    (want, block_s, block_peak) = _peak_of(
        lambda: loss_and_grads(block, params, data), dev)
    (got, policy_s, policy_peak) = _peak_of(
        lambda: loss_and_grads(api, params, data, policy), dev)
    same = torch.equal(got[0], want[0]) and all(
        torch.equal(got[1][k], want[1][k]) for k in want[1])
    rec["policy"] = {"bit_identical": same, "loss": float(got[0]),
                     "block_s": block_s, "policy_s": policy_s,
                     "block_max_memory_allocated": block_peak,
                     "policy_max_memory_allocated": policy_peak}
    log(f"[train_launcher] {card}: policy vs block remat "
        + json.dumps(rec["policy"]))
    if not same:
        raise AssertionError("the TENSILE policy step differs from the "
                             "block remat step")
    del got, want

    # moments on the host: one step each way from the same state (after
    # one step under the policy, so the moments are not zero)
    step = build_train_step(api, TrainStepConfig(remat_policy=policy))
    _, opt, _ = step(params, opt, data)
    start = _host_leaves(params)
    moments = _host_leaves(opt.mu, opt.nu)
    host_opt = opt_state_to_host(opt)
    del opt
    off_step = build_train_step(api, TrainStepConfig(
        remat_policy=policy, offload_opt_state=True))
    (_, host_opt, m_off), off_s, off_peak = _peak_of(
        lambda: off_step(params, host_opt, data), dev)
    off = _host_leaves(params, host_opt.mu, host_opt.nu)
    off_bytes = offloaded_bytes(host_opt)
    pinned = dev != "cuda" or all(t.is_pinned() for t in pytree.tree_leaves(
        (host_opt.mu, host_opt.nu)))
    del host_opt
    with torch.no_grad():
        for p, t in zip(params.parameters(), start):
            p.copy_(t)
    dev_opt = opt_state_for(params)
    with torch.no_grad():
        for d, t in zip(list(dev_opt.mu.values())
                        + list(dev_opt.nu.values()), moments):
            d.copy_(t)
    dev_opt = dev_opt._replace(step=torch.ones((), dtype=torch.int32,
                                               device=dev))
    (_, dev_opt, m_dev), dev_s, dev_peak = _peak_of(
        lambda: step(params, dev_opt, data), dev)
    plain = _host_leaves(params, dev_opt.mu, dev_opt.nu)
    same = _all_equal(off, plain) and torch.equal(m_off["loss"],
                                                  m_dev["loss"])
    rec["opt_host"] = {"bit_identical": same, "offloaded_bytes": off_bytes,
                       "pinned": pinned, "step_s": off_s,
                       "on_card_step_s": dev_s,
                       "max_memory_allocated": off_peak,
                       "on_card_max_memory_allocated": dev_peak}
    log(f"[train_launcher] {card}: moments on the host "
        + json.dumps(rec["opt_host"]))
    del dev_opt, start, moments, off, plain
    if not same or not pinned:
        raise AssertionError("the step with moments on the host is not the "
                             "on-card step bit for bit, or left them "
                             "unpinned")
    if dev == "cuda" and dev_peak - off_peak < 0.8 * off_bytes:
        raise AssertionError(
            f"moments on the host saved {dev_peak - off_peak} B of the "
            f"card, less than 0.8 x {off_bytes} B")

    # int8 error-feedback gradients, the launcher's int8 step on one batch
    del params
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(dict(params.named_parameters()), grad_compression=True)
    comp = build_train_step(api, TrainStepConfig(
        grad_compression="int8", remat_policy=policy))
    losses, comp_s = [], []
    for _ in range(LAUNCHER_INT8_STEPS):
        (_, opt, m), s, _ = _peak_of(lambda: comp(params, opt, data), dev)
        losses.append(float(m["loss"]))
        comp_s.append(s)
    ef_ok = all(bool(torch.isfinite(t).all()) for t in opt.ef.values()) \
        and any(bool(t.abs().max() > 0) for t in opt.ef.values())
    _, grads = loss_and_grads(api, params, data, policy)
    ef = {k: t.clone() for k, t in opt.ef.items()}
    card_g, card_s = ef_compress_grads(grads, opt._replace(ef=ef))
    t0 = time.perf_counter()
    cpu_g, cpu_s = ef_compress_grads(
        {k: g.cpu() for k, g in grads.items()},
        opt._replace(ef={k: t.cpu() for k, t in opt.ef.items()}))
    cpu_time = time.perf_counter() - t0
    bits = all(torch.equal(card_g[k].cpu(), cpu_g[k])
               and torch.equal(card_s.ef[k].cpu(), cpu_s.ef[k])
               for k in grads)
    rec["int8"] = {"losses": losses, "step_s": comp_s, "ef_ok": ef_ok,
                   "card_equals_cpu": bits, "cpu_call_s": cpu_time}
    log(f"[train_launcher] {card}: int8 gradients " + json.dumps(rec["int8"]))
    del grads, card_g, card_s, cpu_g, cpu_s, ef, opt, params
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"int8 training: loss {losses}")
    if not ef_ok or not bits:
        raise AssertionError("int8 gradients: the residual is zero or not "
                             "finite, or the card's call differs from the "
                             "CPU's")
    if dev == "cuda":
        torch.cuda.empty_cache()

    # prefetch, checkpoints and a restart, outside the checkout
    root = tempfile.mkdtemp(prefix="train-launcher-")
    try:
        # bf16 parameters and two fp32 moments: 10 B a parameter
        state_bytes = 5 * sum(p.numel() * p.element_size() for p in
                              get_model(cfg, dev).shell().parameters())
        free = shutil.disk_usage(root).free
        if free < 2.5 * state_bytes:
            raise AssertionError(
                f"{free} B free under {root}: the restart run needs 2.5 x "
                f"the {state_bytes} B state")
        tcfg = TrainStepConfig(remat_policy=policy)
        broken = _restart_run(api, cfg, tcfg, os.path.join(root, "a"), dev,
                              batch, seq, fail_at={LAUNCHER_FAIL_AT: 1})
        if dev == "cuda":
            torch.cuda.empty_cache()
        whole = _restart_run(api, cfg, tcfg, os.path.join(root, "b"), dev,
                             batch, seq)
        rec["restart"] = {"restarts": broken["restarts"],
                          "final_step": broken["final_step"],
                          "same_digest": broken["digest"] == whole["digest"],
                          "fed": broken["fed"], "whole_fed": whole["fed"],
                          "losses": broken["losses"],
                          "whole_losses": whole["losses"],
                          "ckpt_bytes": broken["ckpt_bytes"],
                          "ckpt_s": broken["ckpt_s"],
                          "whole_ckpt_s": whole["ckpt_s"],
                          "free_disk_bytes": free}
        log(f"[train_launcher] {card}: restart " + json.dumps(rec["restart"]))
        resumed = broken["fed"] == whole["fed"] == whole["stream_batches"]
        if not (broken["restarts"] == 1 and whole["restarts"] == 0
                and broken["final_step"] == LAUNCHER_STEPS - 1
                and broken["digest"] == whole["digest"] and resumed):
            raise AssertionError("the restarted run is not the unbroken "
                                 "one: " + json.dumps(rec["restart"]))
        if dev == "cuda":
            torch.cuda.empty_cache()

        # the entry point itself, at its reduced width (``--full`` took
        # 36-50 s more of the script's time limit; TENSILE's decisions at
        # full width are the steps above, the entry point at full width
        # whisper's ``main --full``) with a TENSILE budget from a capture
        # at that width: main captures, schedules for the budget and runs
        # its steps under the remat policy it makes
        main_seq = min(seq, LAUNCHER_MAIN_SEQ)
        budget_mb = main_budget_mb(dev, batch, main_seq)
        args = ["--arch", ARCH, "--steps", str(LAUNCHER_MAIN_STEPS),
                "--batch", str(batch), "--seq", str(main_seq),
                "--tensile-budget-mb", str(budget_mb),
                "--grad-compression", "int8", "--device", dev,
                "--ckpt-dir", os.path.join(root, "main"), "--log-every", "1"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc, main_s, main_peak = _peak_of(
                lambda: launch_train.main(args), dev)
        lines = printed.getvalue().splitlines()
        for line in lines:
            log(f"[train_launcher] main: {line}")
        decided = [ln for ln in lines if ln.startswith("[tensile] ")]
        rec["main"] = {"args": args, "rc": rc, "s": main_s,
                       "max_memory_allocated": main_peak,
                       "decisions": decided}
        log(f"[train_launcher] {card}: main " + json.dumps(rec["main"]))
        if rc != 0 or len(decided) != 1:
            raise AssertionError(f"launch.train.main returned {rc} and "
                                 f"printed the decisions {decided}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


# ----------------------------------------------------------------------
# the MoE slice: Moonlight-16B-A3B and Kimi-K2 at full width
# ----------------------------------------------------------------------
@contextlib.contextmanager
def recording_routes():
    """While active, every router call of ``models/moe.py`` appends its
    experts (T, k) and each token's top-k margin (the k-th probability
    less the (k+1)-th) to the yielded list, on the host, in call order:
    one entry per MoE layer and forward."""
    routes: list = []
    router = moe_mod._router

    def recorded(p, x2d, top_k):
        weights, experts, aux = router(p, x2d, top_k)
        with torch.no_grad():
            probs = torch.softmax(torch.einsum(
                "td,de->te", x2d.float(), p["router"].float()), dim=-1)
            top = torch.topk(probs, min(top_k + 1, probs.shape[-1]),
                             dim=-1).values
            margin = top[:, top_k - 1] - top[:, -1]
        routes.append((experts.detach().cpu(), margin.cpu()))
        return weights, experts, aux

    moe_mod._router = recorded
    try:
        yield routes
    finally:
        moe_mod._router = router


def compare_routes(want: list, got: list, what: str) -> int:
    """The same set of experts for every token of every MoE layer call,
    exactly (the order of a token's k experts only orders the sum of
    their weighted outputs: two near-equal probabilities may swap places
    without changing a choice or a slot); on a flip, the first token's
    layer call, experts and both devices' top-k margins are printed before
    the raise.  Returns the calls."""
    if len(want) != len(got):
        raise AssertionError(f"{what}: {len(got)} router calls, not "
                             f"{len(want)}")
    for layer, ((ew, mw), (eg, mg)) in enumerate(zip(want, got)):
        flips = torch.nonzero((ew.sort(-1).values != eg.sort(-1).values)
                              .any(-1)).flatten()
        if len(flips):
            t = int(flips[0])
            log(f"[routes] {what}: MoE layer call {layer}, token {t}: "
                f"experts {ew[t].tolist()} and {eg[t].tolist()}, top-k "
                f"margins {float(mw[t]):.3e} and {float(mg[t]):.3e}; "
                f"{len(flips)} tokens differ")
            raise AssertionError(f"{what}: expert choices differ at MoE "
                                 f"layer call {layer}")
    return len(want)


@contextlib.contextmanager
def recording_shared(calls: list):
    """While active, each call of ``models/moe.py::_shared_ffn`` appends
    its (params, input, output) to ``calls``."""
    shared = moe_mod._shared_ffn

    def recorded(p, x2d, act):
        y = shared(p, x2d, act)
        calls.append((p, x2d, y))
        return y

    moe_mod._shared_ffn = recorded
    try:
        yield calls
    finally:
        moe_mod._shared_ffn = shared


def serve_numbers(res: dict) -> dict:
    """What the report needs of a ``serve`` result, without its engine."""
    out = {}
    for name, r in res["runs"].items():
        rep = r["report"]
        out[name] = {
            "wall_s": r["wall_s"], "tokens": rep.tokens_generated,
            "tokens_per_s": rep.tokens_generated / r["wall_s"],
            "median_step_ms": r["median_step_ms"],
            "max_memory_allocated": r["max_memory_allocated"],
            "evictions": rep.evictions, "oom_events": rep.oom_events,
            "peak_bytes": rep.peak_bytes, "budget": r["budget"]}
    # the main path's launches: the budgeted run's, counted from 0
    out["budgeted"]["launches"] = res["runs"]["budgeted"]["launches"]
    return out


def moe_prefill_fp32(cfg) -> dict:
    """Moonlight at full width and ``cfg.n_layers`` layers in fp32 (weights
    from seed 0 on the card): the kernel prefill against the plain prefill
    at B x S, end to end, with every token's expert choices equal."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = get_model(cfg, "cuda").init(torch.Generator(
        device="cuda").manual_seed(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    with recording_routes() as r_flash:
        flash = build_prefill_step(get_model(dataclasses.replace(
            cfg, use_flash_kernel=True), "cuda"))(params, batch)
    with recording_routes() as r_plain:
        plain = build_prefill_step(get_model(cfg, "cuda"))(params, batch)
    calls = compare_routes(r_plain, r_flash, f"fp32 {cfg.name} prefill at "
                           f"{cfg.n_layers} layers, kernel vs plain")
    out = {"fp32": rel_max_diff(flash, plain), "router_calls": calls,
           "params_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters())}
    del params, flash, plain
    torch.cuda.empty_cache()
    log(f"[moe] fp32 prefill at {cfg.n_layers} layers: " + json.dumps(out))
    if not out["fp32"] <= PREFILL_REL_TOL["fp32"]:
        raise AssertionError(f"fp32 kernel and plain prefill differ: "
                             f"{out['fp32']} > {PREFILL_REL_TOL['fp32']}")
    return out


def moe_train(link: dict) -> dict:
    """Moonlight at full width and MOE_TRAIN_LAYERS layers: TRAIN_STEPS
    steps of ``build_train_step`` (block remat, the aux loss in the loss),
    whose loss must be finite and fall; then the functional step (no
    remat) captured on fake tensors, its operator latencies measured by an
    unscheduled run, planned by ``tensile`` at MOE_BUDGET of its planned
    peak and run once on ``FxExecutor`` (async swaps) from the same state:
    bit-identical to the unscheduled step, the allocator within
    ALLOC_LEDGER_TOL of the ledger peak, at least one swap-out."""
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    api = get_model(cfg, "cuda")
    batch = api.input_specs(ShapeSpec("moe_train", TRAIN_S, TRAIN_B,
                                      "train"), abstract=False, seed=0)
    params = get_model(cfg, "cuda").init(torch.Generator(
        device="cuda").manual_seed(0))
    opt = opt_state_for(params)
    step = build_train_step(api, TrainStepConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    eager = {"losses": losses, "step_ms": step_ms,
             "median_step_ms": statistics.median(step_ms),
             "tokens_per_s": TRAIN_B * TRAIN_S
             / (statistics.median(step_ms) * 1e-3),
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "param_count": cfg.param_count()}
    log(f"[moe] train {cfg.name} at {MOE_TRAIN_LAYERS} layers, B={TRAIN_B} "
        f"S={TRAIN_S} bf16: " + json.dumps(eager))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE train losses {losses}: not finite or "
                             "not falling")
    del params, opt, step, metrics
    torch.cuda.empty_cache()

    # ---- under TENSILE --------------------------------------------------
    cfg = dataclasses.replace(cfg, remat="none")
    api = get_model(cfg, "cuda")
    fstep = build_functional_train_step(api, TrainStepConfig())
    meta = dict(get_model(cfg, "cuda").shell().named_parameters())
    t0 = time.perf_counter()
    args = pytree.tree_map(lambda p: torch.empty_like(p, device="cuda"),
                           (meta, adamw_init(meta)))
    seq, gm = capture_train_step(fstep, *args, batch,
                                 cost_model=CostModel(calibrate_cuda()))
    capture_s = time.perf_counter() - t0
    del args
    profile = MachineProfile(host_link_bw=link["host_link_bw"],
                             host_link_latency=link["host_link_latency"],
                             dma_batch_overhead=link["dma_batch_overhead"])
    n_state = 1 + 3 * len(meta)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    ex0 = FxExecutor(gm, seq, None, engine=MemoryEngine(profile),
                     measure_latency=True)
    outs, wall_u, alloc_u, ledger_u = _run_state(
        ex0, _tensile_state(cfg, batch), base)
    seq.set_latencies(ex0.stats.op_latencies)
    ref = _host_copy(outs)
    del ex0, outs
    torch.cuda.empty_cache()
    unsched_peak = simulate([seq], None, profile, iterations=1,
                            transfer_mode="sync").peak_bytes
    budget = int(MOE_BUDGET * unsched_peak)
    res, plan_s = _plan(seq, profile, "tensile", budget)
    plan = res.plans[seq.job_id]
    ints = sum(1 for e in plan.events
               if not seq.tensors[e.tensor_id].dtype.startswith(
                   ("float", "bfloat")))
    ex = FxExecutor(gm, seq, plan, async_swap=True,
                    engine=MemoryEngine(profile))
    outs, wall_s_, alloc, ledger = _run_state(ex, _tensile_state(cfg, batch),
                                              base)
    diff = [i for i, (a, b) in enumerate(zip(outs, ref))
            if not torch.equal(a.cpu(), b)]
    out = {"operators": len(seq.operators), "tensors": len(seq.tensors),
           "capture_s": capture_s, "planning_s": plan_s,
           "planned_unscheduled_peak": unsched_peak, "budget": budget,
           "predicted_peak": res.final_report.peak_bytes,
           "plan_events": _event_counts(seq, plan),
           "events_on_integer_tensors": ints,
           "unscheduled": {"wall_s": wall_u, "max_memory_allocated": alloc_u,
                           "ledger_peak": ledger_u},
           "scheduled": {"wall_s": wall_s_, "max_memory_allocated": alloc,
                         "ledger_peak": ledger,
                         "swap_outs": ex.stats.swap_out_count,
                         "swap_ins": ex.stats.swap_in_count,
                         "recomputes": ex.stats.recompute_count},
           "loss": float(outs[n_state]),
           "outputs_differing": len(diff), "eager": eager}
    del ex, outs, ref
    torch.cuda.empty_cache()
    log(f"[moe] tensile {cfg.name} at {MOE_TRAIN_LAYERS} layers: "
        + json.dumps(out))
    if diff:
        raise AssertionError(f"the scheduled MoE step differs from the "
                             f"unscheduled step in outputs {diff[:8]}")
    if abs(alloc / ledger - 1) > ALLOC_LEDGER_TOL:
        raise AssertionError(f"allocator peak {alloc} B is off the ledger "
                             f"peak {ledger} B by more than "
                             f"{ALLOC_LEDGER_TOL:.0%}")
    if out["scheduled"]["swap_outs"] < 1:
        raise AssertionError("the scheduled MoE step swapped nothing out")
    return out


def kimi_prefix_and_shared_expert() -> dict:
    """Kimi-K2 at full width and KIMI_LAYERS layers (the dense prefix layer
    and one MoE layer of 384 experts, top-8, one shared expert; bf16
    weights from seed 0): one prefill at B 1 x S through the flash kernel
    at D 112 (one launch per layer, each layer within the bf16 per-layer
    bound of its plain path, finite logits, the shared expert's output not
    zero and equal to ``_shared_ffn`` run alone on its input, bit for bit),
    then 4 decode steps with finite logits."""
    cfg = dataclasses.replace(get_config(KIMI_ARCH), n_layers=KIMI_LAYERS)
    t0 = time.perf_counter()
    params = get_model(cfg, "cuda").init(torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "param_count": cfg.param_count(),
           "params_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters())}
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_S), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    step = build_prefill_step(get_model(dataclasses.replace(
        cfg, use_flash_kernel=True), "cuda"))
    fa.flash_attention_fwd.launches = 0       # the main path: counts from 0
    with recording_shared([]) as shared:
        logits = step(params, batch)
    torch.cuda.synchronize()
    out["flash_launches"] = fa.flash_attention_fwd.launches
    finite = bool(torch.isfinite(logits).all())
    del logits
    want = mixer_counts(cfg)[fa.flash_attention_fwd]
    if out["flash_launches"] != want or not finite:
        raise AssertionError(f"Kimi-K2 prefill: {out['flash_launches']} "
                             f"flash launches (want {want}), finite "
                             f"{finite}")
    if len(shared) != 1:
        raise AssertionError(f"{len(shared)} shared-expert calls, not 1")
    p, x2d, y = shared[0]
    with torch.inference_mode():
        again = moe_mod._shared_ffn(p, x2d, cfg.mlp_act)
    out["shared_max_abs"] = float(y.float().abs().max())
    if not (out["shared_max_abs"] > 0 and torch.equal(again, y)):
        raise AssertionError("the shared expert's output is zero or differs "
                             "from _shared_ffn alone")
    del shared, p, x2d, y, again
    out["bf16_layer"] = check_layers(params, cfg, batch["tokens"])
    if not out["bf16_layer"] <= MOE_PREFILL_REL_TOL["bf16_layer"]:
        raise AssertionError(f"Kimi-K2 flash per layer: {out['bf16_layer']}"
                             f" > {MOE_PREFILL_REL_TOL['bf16_layer']}")
    out["prefill_ms"] = wall_s(lambda: step(params, batch), 3) * 1e3
    api = get_model(cfg, "cuda")
    cache = api.init_cache(1, 8)
    decode_ms = []
    for i in range(4):
        t = {"tokens": batch["tokens"][:, i:i + 1]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg, cache = api.decode(params, t, cache, i)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"Kimi-K2 decode step {i}: non-finite")
    out["decode_ms"] = decode_ms
    del params, cache, lg
    torch.cuda.empty_cache()
    log(f"[moe] {cfg.name} at {KIMI_LAYERS} layers: " + json.dumps(out))
    return out


def moe(link: dict) -> dict:
    """The MoE slice on the card (see the module docstring); runs in a
    fresh process, on an empty card."""
    deterministic()
    log(card_line())
    for arch in MOE_SMALL_ARCHS:
        timed(f"check_decode {arch}", check_decode_on_small_input, arch)
        timed(f"check_forward {arch}", check_forward_on_small_input, arch)
        timed(f"check_train_step {arch}", check_train_step_on_small_input,
              arch)
    flash_errs = timed("check_flash_moe", check_flash,
                       [FLASH_MOONLIGHT, FLASH_KIMI])
    kv_err = timed("check_leaves_moe", check_leaves,
                   [(MOONLIGHT_LEAVES, 2, 0), (MOONLIGHT_LEAVES, 3, 0)])
    kv = timed("time_leaves_moe", time_leaves, MOONLIGHT_LEAVES, 2)
    log("[time] kv moonlight: " + json.dumps(kv))

    t0 = time.perf_counter()
    res = timed("serve_moe", serve, MachineProfile(), MOE_ARCH)
    eng = res["eng"]
    out = {"serve": serve_numbers(res),
           "params_bytes": sum(p.numel() * p.element_size()
                               for p in eng.params.parameters()),
           "serve_phase_s": time.perf_counter() - t0}
    del res
    out["decode_profile"] = timed("profile_decode_moe", profile_decode, eng)
    out["prefill"] = timed("prefill_moe", prefill, eng,
                           fa.flash_attention_fwd, _attention_mix,
                           MOE_PREFILL_REL_TOL, False)
    del eng
    torch.cuda.empty_cache()
    out["prefill"]["fp32_at_layers"] = timed(
        "prefill_fp32_moe", moe_prefill_fp32, dataclasses.replace(
            get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS))
    out["flash_moonlight"] = timed("time_flash_moe", time_flash,
                                   FLASH_MOONLIGHT)
    out["train"] = timed("train_moe", moe_train, link)
    out["kimi"] = timed("kimi", kimi_prefix_and_shared_expert)
    out["flash_kimi"] = timed("time_flash_kimi", time_flash, FLASH_KIMI)
    out["flash_max_abs_err"] = {"moonlight": flash_errs[FLASH_MOONLIGHT],
                                "kimi": flash_errs[FLASH_KIMI]}
    out["kv"] = kv
    out["kv_max_abs_err"] = kv_err
    for k in ("profile",):
        out["prefill"].pop(k, None)
    log("[moe] " + json.dumps(out))
    return out


# ----------------------------------------------------------------------
# the whisper slice: whisper-base at full width
# ----------------------------------------------------------------------
def whisper_small_checks() -> dict:
    """Reduced whisper in fp32 (2 encoder layers, 1 decoder layer) at B 2
    x WHISPER_SMALL_S frames, the same weights on both devices: the card's
    forward through the flash kernel (one launch per decoder layer)
    against the CPU's plain forward at 5e-4; 6 decode steps, each device
    on its own encoder output, at 1e-4; one train step, loss and grad norm
    at rtol 1e-4, parameters at rtol 2e-2, atol 2e-4."""
    cfg = get_config(WHISPER_ARCH).reduced()
    cpu, card = small_models(cfg)
    api_c = get_model(cfg, "cpu")
    batch = api_c.input_specs(ShapeSpec("whisper_small", WHISPER_SMALL_S, 2,
                                        "train"), abstract=False, seed=1)
    on_card = {k: v.cuda() for k, v in batch.items()}
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    # on the card's host the CPU's first forward of a process has returned
    # wrong rope cosines now and then (ROADMAP §3): the reference is the
    # second, and the first's gap to it is logged on every run
    first = build_prefill_step(api_c)(cpu, fwd)
    want = build_prefill_step(api_c)(cpu, fwd)
    cpu_gap = max_abs_err(first, want)
    log(f"[whisper] reduced CPU forward: first vs second of the process "
        f"differ by {cpu_gap}")
    n0 = fa.flash_attention_fwd.launches
    got = build_prefill_step(get_model(dataclasses.replace(
        cfg, use_flash_kernel=True), "cuda"))(
            card, {k: v for k, v in on_card.items() if k != "labels"})
    torch.cuda.synchronize()
    launches = fa.flash_attention_fwd.launches - n0
    out = {"forward_launches": launches,
           "forward": max_abs_err(got.cpu(), want),
           "cpu_first_forward_gap": cpu_gap}
    if launches != cfg.n_layers:
        raise AssertionError(f"the reduced whisper forward launched the "
                             f"flash kernel {launches} times, not "
                             f"{cfg.n_layers}")
    if not torch.allclose(got.cpu(), want, atol=5e-4, rtol=5e-4):
        raise AssertionError(f"reduced whisper forward: card and CPU differ "
                             f"by {out['forward']}")

    def steps_on(params, dev):
        api = get_model(cfg, dev)
        cache = api.init_cache(2, 8)
        tok = torch.Generator().manual_seed(1)
        logits = []
        with torch.inference_mode():
            enc = whisper_mod.encode(params, batch["audio_feats"].to(dev),
                                     cfg)
            for i in range(6):
                t = torch.randint(0, cfg.vocab_size, (2, 1), generator=tok)
                lg, _ = api.decode(params, {"tokens": t.to(dev),
                                            "enc_out": enc}, cache, i)
                logits.append(lg.cpu())
        return logits

    for i, (lg, lc) in enumerate(zip(steps_on(card, "cuda"),
                                     steps_on(cpu, "cpu"))):
        out["decode"] = max(out.get("decode", 0.0), max_abs_err(lg, lc))
        if not torch.allclose(lg, lc, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"reduced whisper decode step {i}: card and "
                                 f"CPU differ by {max_abs_err(lg, lc)}")
    _, _, mc = build_train_step(api_c)(cpu, opt_state_for(cpu), batch)
    _, _, mg = build_train_step(get_model(cfg, "cuda"))(
        card, opt_state_for(card), on_card)
    torch.cuda.synchronize()
    for key in ("loss", "grad_norm"):
        if not np.isclose(float(mg[key]), float(mc[key]), rtol=1e-4):
            raise AssertionError(f"reduced whisper train step {key}: card "
                                 f"{float(mg[key])}, CPU {float(mc[key])}")
    want_p = cpu.state_dict()
    for k, t in card.state_dict().items():
        if not torch.allclose(t.cpu(), want_p[k], rtol=2e-2, atol=2e-4):
            raise AssertionError(f"reduced whisper train step: {k} differs "
                                 f"by {max_abs_err(t.cpu(), want_p[k])}")
    out["train_loss"] = {"card": float(mg["loss"]), "cpu": float(mc["loss"])}
    log("[whisper] reduced fp32 card vs CPU (forward 5e-4, decode 1e-4, "
        "train step): " + json.dumps(out))
    return out


def whisper_batch(cfg, kind: str, seed: int = 0) -> dict:
    """A full-width batch of WHISPER_B windows: ``input_specs`` frames
    (normal, seed ``seed``), tokens (and labels) drawn over the vocabulary
    from numpy ``seed`` (``input_specs`` draws ids under 32)."""
    api = get_model(cfg, "cuda")
    batch = api.input_specs(ShapeSpec(f"whisper_{kind}", WHISPER_S,
                                      WHISPER_B, kind), abstract=False,
                            seed=seed)
    rng = np.random.default_rng(seed)
    for k in ("tokens", "labels"):
        if k in batch:
            batch[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, tuple(batch[k].shape),
                dtype=np.int32)).cuda()
    return batch


def whisper_layers(params, cfg, batch) -> float:
    """Each decoder layer's causal self-attention on the hidden state the
    kernel forward feeds it, through the kernel and the plain path: the
    largest relative difference over the layers."""
    flash_cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    worst = 0.0
    with torch.inference_mode():
        enc_out = whisper_mod.encode(params, batch["audio_feats"], cfg)
        x = embed_tokens(params["embed"], batch["tokens"]).to(
            getattr(torch, cfg.dtype))
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b,
                                                                        s)
        for i in range(cfg.n_layers):
            p = params["dec_blocks"].at(i)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            worst = max(worst, rel_max_diff(
                _attention_mix(p, h, pos, flash_cfg),
                _attention_mix(p, h, pos, cfg)))
            x = whisper_mod.decoder_layer(p, x, enc_out, pos, flash_cfg)
    return worst


def whisper_prefill(params, cfg) -> dict:
    """The full-width prefill (B 16 windows of 1500 frames, 375 tokens)
    through ``build_prefill_step`` with the flash kernel: the logits'
    shape and finiteness, one launch per decoder layer counted from 0
    (none for the encoder or the cross-attention), agreement with the
    plain attention path end to end in bf16 and per layer, and end to end
    with the weights widened to fp32 at full depth (PREFILL_REL_TOL)."""
    flash_cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    step = build_prefill_step(get_model(flash_cfg, "cuda"))
    plain_step = build_prefill_step(get_model(cfg, "cuda"))
    batch = whisper_batch(cfg, "prefill")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0      # the main path: counts from 0
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    want = (WHISPER_B, WHISPER_S // cfg.enc_seq_ratio, cfg.padded_vocab)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"whisper prefill logits {tuple(logits.shape)},"
                             f" want {want} and finite")
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} flash launches in one whisper "
                             f"forward, want {cfg.n_layers}")
    plain = plain_step(params, batch)
    if fa.flash_attention_fwd.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    agree = {"bf16": rel_max_diff(logits, plain),
             "argmax_agreement": float((logits.argmax(-1)
                                        == plain.argmax(-1)).float().mean()),
             "bf16_layer": whisper_layers(params, cfg, batch)}
    del logits, plain
    wide, cfg32 = widened(params, cfg, "float32")
    agree["fp32"] = rel_max_diff(
        build_prefill_step(get_model(dataclasses.replace(
            cfg32, use_flash_kernel=True), "cuda"))(wide, batch),
        build_prefill_step(get_model(cfg32, "cuda"))(wide, batch))
    del wide
    torch.cuda.empty_cache()
    log("[whisper] prefill, kernel vs plain path, max |diff| / max |ref|: "
        + json.dumps(agree))
    for key, tol in PREFILL_REL_TOL.items():
        if not agree[key] <= tol:
            raise AssertionError(f"whisper kernel and plain prefill differ "
                                 f"({key}): {agree[key]} > {tol}")
    wall = wall_s(lambda: step(params, batch), 3)
    plain_wall = wall_s(lambda: plain_step(params, batch), 3)
    prof = profile_window(lambda: step(params, batch),
                          KERNEL_NAMES[fa.flash_attention_fwd])
    for name, (count, _) in prof["named"].items():
        if count != launches:
            raise AssertionError(f"the whisper prefill's profile holds "
                                 f"{count} {name} kernels, not {launches}")
    out = {"launches": launches, "first_call_s": first_s,
           "wall_ms": wall * 1e3, "plain_wall_ms": plain_wall * 1e3,
           "windows_per_s": WHISPER_B / wall,
           "tokens_per_s": WHISPER_B * want[1] / wall,
           "max_memory_allocated": peak,
           "device_kernels": prof["device_kernels"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_idle_share": prof["device_idle_share"],
           "top_kernels_ms": prof["top_kernels_ms"],
           "kernel_device_ms": sum(
               ms for _, ms in prof["named"].values()) / launches, **agree}
    log(f"[whisper] prefill B={WHISPER_B} frames={WHISPER_S} tokens="
        f"{want[1]} bf16, kernel path: " + json.dumps(out))
    return out


def whisper_greedy(params, cfg, audio, steps: int) -> tuple:
    """Encode ``audio`` once, then ``steps`` greedy steps of
    ``build_serve_step`` from an empty cache of WHISPER_MAX_LEN positions
    (the first tokens from numpy seed 2) on batches shaped as
    ``decode_input_specs`` gives them.  Returns the encoder output, the
    tokens fed, each step's logits and each step's milliseconds."""
    api = get_model(cfg, "cuda")
    step = build_serve_step(api)
    specs = api.decode_input_specs(ShapeSpec(
        "whisper_decode", WHISPER_S * cfg.enc_seq_ratio, WHISPER_B,
        "decode"))
    with torch.inference_mode():
        enc_out = whisper_mod.encode(params, audio, cfg)
    cache = api.init_cache(WHISPER_B, WHISPER_MAX_LEN)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (WHISPER_B, 1), dtype=np.int32)).cuda()
    fed, logits, ms = [], [], []
    for i in range(steps):
        batch = {"tokens": tok, "enc_out": enc_out}
        if i == 0 and {k: (tuple(v.shape), v.dtype) for k, v in
                       batch.items()} != {k: (tuple(v.shape), v.dtype)
                                          for k, v in specs.items()}:
            raise AssertionError("the decode batch is not shaped as "
                                 "decode_input_specs gives it")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, cache, batch, i)
        tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        fed.append(batch["tokens"])
        logits.append(lg[:, 0])
    return enc_out, torch.cat(fed, 1), torch.stack(logits, 1), ms, cache


def whisper_decode(params, cfg) -> dict:
    """Full-width decode at B 16: WHISPER_DECODE_STEPS greedy steps in bf16
    (ms a step, tokens/s, and a profiled window of 4 more steps: kernels a
    step, busy ms, idle share), then the same in fp32, whose steps' logits
    must equal the decoder's forward over the tokens fed within
    DECODE_FORWARD_TOL (allclose rtol = atol)."""
    audio = whisper_batch(cfg, "prefill", seed=1)["audio_feats"]
    enc_out, _, _, ms, cache = whisper_greedy(params, cfg, audio,
                                              WHISPER_DECODE_STEPS)
    step = build_serve_step(get_model(cfg, "cuda"))
    tok = torch.zeros((WHISPER_B, 1), dtype=torch.int32, device="cuda")
    n = WHISPER_DECODE_STEPS

    def run():
        for i in range(4):
            step(params, cache, {"tokens": tok, "enc_out": enc_out}, n + i)

    prof = profile_window(run)
    med = statistics.median(ms[1:])
    out = {"steps": n, "first_step_ms": ms[0], "median_step_ms": med,
           "tokens_per_s": WHISPER_B / (med * 1e-3),
           "profiled_wall_ms_per_step": prof["wall_ms"] / 4,
           "device_kernels_per_step": prof["device_kernels"] / 4,
           "device_busy_ms_per_step": prof["device_busy_ms"] / 4,
           "device_idle_share": prof["device_idle_share"],
           "top_kernels_ms": prof["top_kernels_ms"]}
    del enc_out, cache
    wide, cfg32 = widened(params, cfg, "float32")
    enc32, fed, logits, _, _ = whisper_greedy(wide, cfg32, audio, n)
    with torch.inference_mode():
        par = whisper_mod.decode_train(wide, fed, enc32, cfg32)
    out["fp32_decode_vs_forward"] = max_abs_err(logits, par)
    log(f"[whisper] decode B={WHISPER_B} bf16: " + json.dumps(out))
    if not torch.allclose(logits, par, rtol=DECODE_FORWARD_TOL,
                          atol=DECODE_FORWARD_TOL):
        raise AssertionError(f"fp32 whisper decode steps differ from the "
                             f"forward by {out['fp32_decode_vs_forward']}")
    del wide, enc32, logits, par
    torch.cuda.empty_cache()
    return out


def whisper_train(params, cfg) -> dict:
    """WHISPER_TRAIN_STEPS steps of ``build_train_step`` (AdamW lr 1e-4,
    block remat, the plain attention path) on one fixed full-width batch,
    updating ``params`` in place: finite losses, the last below the first;
    the cross-attention biases, which the loss never reads, exactly zero
    after the steps, and the self-attention biases moved (the control)."""
    api = get_model(cfg, "cuda")
    batch = whisper_batch(cfg, "train")
    step = build_train_step(api, TrainStepConfig())
    opt = opt_state_for(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(WHISPER_TRAIN_STEPS):
        t0 = time.perf_counter()
        _, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    med = statistics.median(step_ms)
    state = params.state_dict()
    nonzero = {k: int(torch.count_nonzero(state[f"dec_blocks.{k}"]))
               for k in ("xattn.bq", "xattn.bk", "xattn.bv", "attn.bq")}
    out = {"losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "windows_per_s": WHISPER_B / (med * 1e-3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "nonzero_biases": nonzero}
    log(f"[whisper] train B={WHISPER_B} frames={WHISPER_S} bf16, "
        f"{WHISPER_TRAIN_STEPS} steps: " + json.dumps(out))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"whisper train losses {losses}: not finite "
                             "or not falling")
    if any(nonzero[k] for k in ("xattn.bq", "xattn.bk", "xattn.bv")):
        raise AssertionError(f"a cross-attention bias moved: {nonzero}")
    if not nonzero["attn.bq"]:
        raise AssertionError("the self-attention biases did not train")
    del opt
    return out


def _most_read(seq, shape) -> str:
    """The activation storage of ``shape`` that the most operators read:
    the encoder's output, which each decoder layer's cross-attention
    reads forward and backward."""
    reads = collections.Counter()
    for op in seq.operators:
        for t in set(op.inputs):
            spec = seq.tensors[t]
            if (spec.kind.value == "activation"
                    and tuple(spec.shape) == tuple(shape)):
                reads[t] += 1
    return reads.most_common(1)[0][0]


def whisper_tensile(link: dict) -> dict:
    """The functional train step without remat at full width (B 16 x 1500
    frames) captured on fake tensors; its operator latencies measured by
    one unscheduled run, a second unscheduled run timed; planned by
    ``tensile`` at WHISPER_BUDGET of its planned peak and run on
    ``FxExecutor`` (async swaps) from the same state: bit-identical to the
    unscheduled step, the allocator within ALLOC_LEDGER_TOL of the ledger
    peak, at least one swap-out.  Also what the plan does with the
    encoder's output."""
    cfg = dataclasses.replace(get_config(WHISPER_ARCH), remat="none")
    api = get_model(cfg, "cuda")
    batch = whisper_batch(cfg, "train")
    fstep = build_functional_train_step(api, TrainStepConfig())
    meta = dict(api.shell().named_parameters())
    t0 = time.perf_counter()
    args = pytree.tree_map(lambda p: torch.empty_like(p, device="cuda"),
                           (meta, adamw_init(meta)))
    seq, gm = capture_train_step(fstep, *args, batch,
                                 cost_model=CostModel(calibrate_cuda()))
    capture_s = time.perf_counter() - t0
    del args
    profile = MachineProfile(host_link_bw=link["host_link_bw"],
                             host_link_latency=link["host_link_latency"],
                             dma_batch_overhead=link["dma_batch_overhead"])
    n_state = 1 + 3 * len(meta)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    unsched = []
    for measure in (True, False):
        ex0 = FxExecutor(gm, seq, None, engine=MemoryEngine(profile),
                         measure_latency=measure)
        outs, wall_u, alloc_u, ledger_u = _run_state(
            ex0, _tensile_state(cfg, batch), base)
        unsched.append({"wall_s": wall_u, "max_memory_allocated": alloc_u,
                        "ledger_peak": ledger_u})
        if measure:
            seq.set_latencies(ex0.stats.op_latencies)
        else:
            ref = _host_copy(outs)
        del ex0, outs
        torch.cuda.empty_cache()
    unsched_peak = simulate([seq], None, profile, iterations=1,
                            transfer_mode="sync").peak_bytes
    budget = int(WHISPER_BUDGET * unsched_peak)
    res, plan_s = _plan(seq, profile, "tensile", budget)
    plan = res.plans[seq.job_id]
    enc_out = _most_read(seq, (WHISPER_B, WHISPER_S, cfg.d_model))
    enc_events = collections.Counter(e.event_type.value for e in plan.events
                                     if e.tensor_id == enc_out)
    ex = FxExecutor(gm, seq, plan, async_swap=True,
                    engine=MemoryEngine(profile))
    outs, wall_s_, alloc, ledger = _run_state(ex, _tensile_state(cfg, batch),
                                              base)
    diff = [i for i, (a, b) in enumerate(zip(outs, ref))
            if not torch.equal(a.cpu(), b)]
    u = unsched[1]
    out = {"operators": len(seq.operators), "tensors": len(seq.tensors),
           "capture_s": capture_s, "planning_s": plan_s,
           "planned_unscheduled_peak": unsched_peak, "budget": budget,
           "predicted_peak": res.final_report.peak_bytes,
           "predicted_MSR": 1 - res.final_report.peak_bytes / unsched_peak,
           "plan_events": _event_counts(seq, plan),
           "unscheduled": unsched,
           "scheduled": {"wall_s": wall_s_, "max_memory_allocated": alloc,
                         "ledger_peak": ledger,
                         "swap_outs": ex.stats.swap_out_count,
                         "swap_ins": ex.stats.swap_in_count,
                         "recomputes": ex.stats.recompute_count},
           "measured_MSR": 1 - alloc / u["max_memory_allocated"],
           "measured_EOR": wall_s_ / u["wall_s"] - 1,
           "enc_out": {"tensor": enc_out,
                       "bytes": seq.tensors[enc_out].size_bytes,
                       "readers": sum(enc_out in op.inputs
                                      for op in seq.operators),
                       "plan_events": dict(enc_events),
                       "treated": ("recomputed" if enc_events["recompute"]
                                   else "swapped" if enc_events["swap_out"]
                                   else "kept")},
           "loss": float(outs[n_state]), "outputs_differing": len(diff)}
    del ex, outs, ref
    torch.cuda.empty_cache()
    log("[whisper] tensile: " + json.dumps(out))
    if diff:
        raise AssertionError(f"the scheduled whisper step differs from the "
                             f"unscheduled step in outputs {diff[:8]}")
    if abs(alloc / ledger - 1) > ALLOC_LEDGER_TOL:
        raise AssertionError(f"allocator peak {alloc} B is off the ledger "
                             f"peak {ledger} B by more than "
                             f"{ALLOC_LEDGER_TOL:.0%}")
    if out["scheduled"]["swap_outs"] < 1:
        raise AssertionError("the scheduled whisper step swapped nothing "
                             "out")
    return out


def whisper(link: dict) -> dict:
    """The whisper slice on the card (see the module docstring); runs in a
    fresh process, on an empty card."""
    deterministic()
    log(card_line())
    t_phase = time.perf_counter()
    flash_errs = timed("check_flash_whisper", check_flash,
                       [FLASH_WHISPER, FLASH_WHISPER_FP32])
    out = {"flash": timed("time_flash_whisper", time_flash, FLASH_WHISPER),
           "flash_max_abs_err": {"bf16": flash_errs[FLASH_WHISPER],
                                 "fp32": flash_errs[FLASH_WHISPER_FP32]}}
    out["small"] = timed("whisper_small_checks", whisper_small_checks)
    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    params = get_model(cfg, "cuda").init(torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out["draw_s"] = time.perf_counter() - t0
    out["param_count"] = cfg.param_count()
    out["params_bytes"] = sum(p.numel() * p.element_size()
                              for p in params.parameters())
    out["prefill"] = timed("whisper_prefill", whisper_prefill, params, cfg)
    out["decode"] = timed("whisper_decode", whisper_decode, params, cfg)
    out["train"] = timed("whisper_train", whisper_train, params, cfg)
    del params
    torch.cuda.empty_cache()
    out["tensile"] = timed("whisper_tensile", whisper_tensile, link)
    root = tempfile.mkdtemp(prefix="whisper-launcher-")
    try:
        args = ["--arch", WHISPER_ARCH, "--full", "--batch", str(WHISPER_B),
                "--seq", str(WHISPER_S), "--steps", "3", "--ckpt-dir", root,
                "--log-every", "1"]
        rc, main_s, main_peak = _peak_of(lambda: launch_train.main(args),
                                         "cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["main"] = {"args": args, "rc": rc, "s": main_s,
                   "max_memory_allocated": main_peak}
    if rc != 0:
        raise AssertionError(f"launch.train.main --arch {WHISPER_ARCH} "
                             f"returned {rc}")
    out["phase_s"] = time.perf_counter() - t_phase
    log("[whisper] " + json.dumps({k: out[k] for k in (
        "draw_s", "param_count", "params_bytes", "main", "phase_s")}))
    return out


# ----------------------------------------------------------------------
# distribution: TinyLlama-1.1B at full width on a one-device mesh
# ----------------------------------------------------------------------
# the allocator's peak of the steps under the mesh over the meshless one's
MESH_MEMORY_TOL = 0.05
PSUM_ELEMENTS = 16 << 20                # 64 MiB of fp32
DIST_LAUNCHER_STEPS = 3


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor, a ``HostShard``'s host tensor, or ``t``."""
    if isinstance(t, HostShard):
        return t.local
    return t.to_local() if hasattr(t, "to_local") else t


def _moments_pinned(opt, dev: str) -> bool:
    """Whether every moment is a ``HostShard`` whose host tensor is pinned
    (on the CPU: a plain host tensor)."""
    return all(isinstance(t, HostShard) and (dev != "cuda"
                                             or t.local.is_pinned())
               for t in pytree.tree_leaves((opt.mu, opt.nu)))


def _named_host(params, opt) -> dict:
    """Host copies of the parameters and both moments, by name (a
    DTensor's local shard: on a one-device mesh, the whole tensor)."""
    out = {"p:" + k: _local(p).detach().to("cpu", copy=True)
           for k, p in params.named_parameters()}
    for tag, tree in (("mu:", opt.mu), ("nu:", opt.nu)):
        out.update({tag + k: _local(t).to("cpu", copy=True)
                    for k, t in tree.items()})
    return out


def _two_steps(api, params, batch, rules, dev: str, offload: bool = False,
               keep: bool = True) -> dict:
    """Two train steps from ``params`` (in place) with a fresh AdamW state,
    with ``offload`` its moments in host memory from the start (under
    ``rules``, host shards placed by ``opt_state_shardings``): the
    losses, each step's wall ms, the allocator's peak over the steps,
    ``card_digest`` of each parameter and moment after them and, with
    ``keep``, host copies of them; with ``offload``, whether the moments
    were pinned host shards after each step (under ``rules``) and
    ``offloaded_bytes``."""
    step = build_train_step(api, TrainStepConfig(offload_opt_state=offload),
                            rules=rules)
    if rules is not None:
        shard_params(params, rules)
    opt = opt_state_for(params)
    if offload:
        opt = opt_state_to_host(opt, None if rules is None else
                                opt_state_shardings(rules, {
                                    k: Sharding.of(p) for k, p in
                                    params.named_parameters()},
                                    offload=True))
        if dev == "cuda":
            torch.cuda.empty_cache()
    losses, ms, pinned = [], [], []
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t0 = time.perf_counter()
        _, opt, m = step(params, opt, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if offload and rules is not None:
            pinned.append(_moments_pinned(opt, dev))
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    out = {"losses": losses, "step_ms": ms, "max_memory_allocated": peak,
           "digests": _leaf_digests(params, opt)}
    if keep:
        out["state"] = _named_host(params, opt)
    if offload:
        out["pinned"] = pinned
        out["offloaded_bytes"] = offloaded_bytes(opt)
    return out


def distribution(device: str = "cuda", cfg=None,
                 prefill_shape=(PREFILL_B, PREFILL_S),
                 train_shape=(TRAIN_B, TRAIN_S)) -> dict:
    """The distribution slice on the card: a world of one (NCCL), the
    host mesh over it and full-width TinyLlama-1.1B under its rules,
    against the meshless path bit for bit.  Runs in a fresh process
    (``in_fresh_process``).  ``device``, ``cfg`` and the shapes rehearse
    it on the CPU at a reduced size (gloo)."""
    deterministic()
    dev = device
    cfg = cfg or get_config(ARCH)
    rec: dict = {"card": card_line() if dev == "cuda" else "cpu"}
    rec["world"] = init_world(dev)
    mesh = make_host_mesh(device=dev)
    rec["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if rec["world"] != 1 or tuple(mesh.shape) != (1, 1):
        raise AssertionError(f"a world of {rec['world']} and a mesh "
                             f"{rec['mesh']}, want one rank and (1, 1)")
    rules = MeshRules(mesh, cfg=cfg)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    # the prefill through the flash kernel, meshless then under the rules
    api = get_model(dataclasses.replace(cfg, use_flash_kernel=True), dev)
    b, s = prefill_shape
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s),
                                               dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    plain_params = api.init(gen())
    plain_step = build_prefill_step(api)
    want = plain_step(plain_params, batch)
    mesh_params = api.init(gen())
    shard_params(mesh_params, rules)
    step = build_prefill_step(api, rules=rules)
    sync()
    fa.flash_attention_fwd.launches = 0      # the main path: counts from 0
    got = step(mesh_params, batch)
    sync()
    launches = fa.flash_attention_fwd.launches
    same = torch.equal(_local(got), want)
    times = {"meshless_ms": wall_s(lambda: plain_step(plain_params, batch),
                                   3) * 1e3 if dev == "cuda" else None,
             "mesh_ms": wall_s(lambda: step(mesh_params, batch), 3) * 1e3
             if dev == "cuda" else None}
    rec["prefill"] = {"launches": launches, "bit_identical": same,
                      "placements": str(got.placements),
                      "shape": list(got.shape), **times}
    log(f"[distribution] prefill B={b} S={s}: " + json.dumps(rec["prefill"]))
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} flash launches under the mesh, "
                             f"want {cfg.n_layers}")
    if not same:
        raise AssertionError("the prefill under the mesh is not the "
                             "meshless one bit for bit")
    del want, got, plain_params, mesh_params, step, plain_step

    # two train steps each way, one state on the card at a time: meshless,
    # the moments on the host meshless and under the rules, then under the
    # rules on the card (last: the elastic checks take its parameters)
    api = get_model(cfg, dev)
    b, s = train_shape
    tbatch = api.input_specs(ShapeSpec("smoke_train", s, b, "train"),
                             abstract=False, seed=0)
    params = api.init(gen())
    plain = _two_steps(api, params, tbatch, None, dev)
    runs = {}
    t_host = time.perf_counter()
    for tag, r in (("meshless_host", None), ("mesh_host", rules)):
        del params
        if dev == "cuda":
            torch.cuda.empty_cache()
        params = api.init(gen())
        runs[tag] = _two_steps(api, params, tbatch, r, dev, offload=True,
                               keep=False)
    host_s = time.perf_counter() - t_host
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    params = api.init(gen())
    sharded = _two_steps(api, params, tbatch, rules, dev)
    mismatched = [k for k, t in plain["state"].items()
                  if not torch.equal(t, sharded["state"][k])]
    rec["train"] = {k: {"losses": r["losses"], "step_ms": r["step_ms"],
                        "max_memory_allocated": r["max_memory_allocated"]}
                    for k, r in (("meshless", plain), ("mesh", sharded))}
    rec["train"]["mismatched_leaves"] = mismatched
    log(f"[distribution] train B={b} S={s}: " + json.dumps(rec["train"]))
    if plain["losses"] != sharded["losses"] or mismatched:
        raise AssertionError("two steps under the mesh are not the meshless "
                             f"ones bit for bit: {rec['train']}")
    if dev == "cuda" and sharded["max_memory_allocated"] > (
            1 + MESH_MEMORY_TOL) * plain["max_memory_allocated"]:
        raise AssertionError("the steps under the mesh allocated more than "
                             f"{1 + MESH_MEMORY_TOL} x the meshless ones")

    # the moments in pinned host memory under the rules: host shards, bit
    # for bit the steps with them on the card and the meshless host steps
    host, mhost = runs["mesh_host"], runs["meshless_host"]
    against = {tag: [k for k, h in r["digests"].items()
                     if host["digests"].get(k) != h]
               + sorted(set(host["digests"]) ^ set(r["digests"]))
               for tag, r in (("mesh", sharded), ("meshless_host", mhost))}
    saved = (sharded["max_memory_allocated"] - host["max_memory_allocated"]
             if dev == "cuda" else None)
    rec["host_state"] = {
        **{tag: {"losses": r["losses"], "step_ms": r["step_ms"],
                 "max_memory_allocated": r["max_memory_allocated"]}
           for tag, r in runs.items()},
        "on_card_mesh_step_ms": sharded["step_ms"],
        "pinned_host_shards": host["pinned"],
        "offloaded_bytes": host["offloaded_bytes"],
        "saved_bytes": saved, "leaves": len(host["digests"]),
        "mismatched_leaves": against, "seconds": host_s}
    log(f"[distribution] moments on the host under the mesh B={b} S={s}: "
        + json.dumps(rec["host_state"]))
    if any(against.values()) or not (
            host["losses"] == sharded["losses"] == mhost["losses"]):
        raise AssertionError("the steps with the moments on the host under "
                             "the mesh are not the on-card mesh steps and "
                             "the meshless host steps bit for bit: "
                             f"{rec['host_state']}")
    if len(host["pinned"]) != 2 or not all(host["pinned"]):
        raise AssertionError("a moment under the mesh was not a pinned host "
                             "shard between steps")
    if dev == "cuda" and saved < 0.8 * host["offloaded_bytes"]:
        raise AssertionError(
            f"moments on the host under the mesh saved {saved} B of the "
            f"card, less than 0.8 x {host['offloaded_bytes']} B")
    del plain, sharded, runs, host, mhost

    # the compressed collective over the world: one rank's mean is its own
    # quantization
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        PSUM_ELEMENTS, dtype=np.float32)).to(dev)
    y = compressed_psum_mean(x)
    rec["psum"] = {"bit_equal": torch.equal(y, quantize_dequantize(x)),
                   "bytes": x.numel() * x.element_size(),
                   "ms": wall_s(lambda: compressed_psum_mean(x), 3) * 1e3
                   if dev == "cuda" else None}
    log("[distribution] compressed_psum_mean: " + json.dumps(rec["psum"]))
    if not rec["psum"]["bit_equal"]:
        raise AssertionError("compressed_psum_mean over one rank is not "
                             "quantize_dequantize bit for bit")
    del x, y

    # elastic: onto a second (1, 1) mesh, and a checkpoint restored into a
    # DTensor template
    state = dict(params.named_parameters())
    axes = params.named_param_axes()
    moved, _ = reshard_state(state, {k: axes[k] for k in state},
                             make_mesh((1, 1), ("data", "model")), cfg=cfg)
    resharded = all(torch.equal(_local(moved[k]), _local(t))
                    for k, t in state.items())
    del moved
    root = tempfile.mkdtemp(prefix="distribution-")
    try:
        t0 = time.perf_counter()
        mgr = CheckpointManager(os.path.join(root, "ckpt"))
        mgr.save(0, params)
        template = api.init(torch.Generator(device=dev).manual_seed(1))
        shard_params(template, rules)
        mgr.restore(0, template=template)
        restored = all(torch.equal(_local(a), _local(b_)) for a, b_ in zip(
            params.parameters(), template.parameters()))
        rec["elastic"] = {"reshard_bit_identical": resharded,
                          "restore_bit_identical": restored,
                          "checkpoint_s": time.perf_counter() - t0}
        log("[distribution] elastic: " + json.dumps(rec["elastic"]))
        if not (resharded and restored):
            raise AssertionError(f"reshard or restore changed a value: "
                                 f"{rec['elastic']}")
        del template, params, state
        if dev == "cuda":
            torch.cuda.empty_cache()

        # the launcher on the mesh
        args = ["--arch", ARCH, "--mesh", "1,1",
                "--steps", str(DIST_LAUNCHER_STEPS), "--batch", str(b),
                "--seq", str(s), "--device", dev, "--log-every", "1",
                "--ckpt-dir", os.path.join(root, "main")]
        args += ["--full"] if cfg.n_layers == get_config(ARCH).n_layers \
            else ["--reduced"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc, main_s, main_peak = _peak_of(lambda: launch_train.main(args),
                                             dev)
        lines = printed.getvalue().splitlines()
        losses = [float(ln.split()[3]) for ln in lines
                  if ln.startswith("  step")]
        rec["launcher"] = {"args": args, "rc": rc, "s": main_s,
                           "losses": losses,
                           "max_memory_allocated": main_peak}
        log("[distribution] launcher: " + json.dumps(rec["launcher"]))
        if rc != 0 or len(losses) != DIST_LAUNCHER_STEPS \
                or not all(np.isfinite(losses)) \
                or not any("mesh={'data': 1, 'model': 1}" in ln
                           for ln in lines):
            raise AssertionError(f"launch.train.main --mesh 1,1: {lines}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


DIGEST_CHUNK = 1 << 26                  # elements hashed at a time


def card_digest(t: torch.Tensor) -> tuple:
    """``t``'s shape, dtype and a 64-bit hash of its bits computed where
    it lies: the sum, wrapping in int64, of each element's bit pattern
    times an odd weight mixed from its index.  Equal bits give equal
    hashes; tensors whose bits differ collide with a chance near 2^-63.
    (A host sha256 of Moonlight's 30 GB of state per run cost about a
    minute.)"""
    flat = t.detach().contiguous().reshape(-1)
    flat = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    h = torch.zeros((), dtype=torch.int64, device=flat.device)
    for i in range(0, flat.numel(), DIGEST_CHUNK):
        v = flat[i:i + DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(i, i + v.numel(), dtype=torch.int64,
                         device=flat.device) * -7046029254386353131
        w = (w ^ (w >> 31)) * -4658895280553007687 | 1
        h += (v * w).sum()
    return tuple(t.shape), str(t.dtype), int(h)


def _leaf_digests(params, opt) -> dict:
    """``card_digest`` of each parameter and moment (its local shard: on a
    one-device mesh, the whole tensor), by name, computed on the
    parameters' device (a moment in host memory is copied there)."""
    out = {"p:" + k: card_digest(_local(p)) for k, p in
           params.named_parameters()}
    dev = _local(next(params.parameters())).device
    for tag, tree in (("mu:", opt.mu), ("nu:", opt.nu)):
        out.update({tag + k: card_digest(_local(t).to(dev))
                    for k, t in tree.items()})
    return out


def moe_mesh(device: str = "cuda", cfg=None,
             prefill_shape=(PREFILL_B, PREFILL_S),
             train_shape=(TRAIN_B, TRAIN_S)) -> dict:
    """Full-width Moonlight-16B-A3B at MOE_TRAIN_LAYERS layers on the
    (1, 1) host mesh, whose scatter MoE routes the tokens' data shards: a
    bf16 prefill through the flash kernel and two train steps, each
    meshless then under the rules.  Gates: the logits, the losses, every
    parameter and both moments bit-identical (``card_digest``), one flash
    launch per layer under the mesh, the allocator's peak over the steps
    under the mesh within MESH_MEMORY_TOL of meshless.  Runs in the
    distribution phase's process; ``device``, ``cfg`` and the shapes
    rehearse it on the CPU at a reduced size."""
    t0 = time.perf_counter()
    deterministic()
    dev = device
    cfg = cfg or dataclasses.replace(get_config(MOE_ARCH),
                                     n_layers=MOE_TRAIN_LAYERS)
    init_world(dev)
    mesh = make_host_mesh(device=dev)
    if tuple(mesh.shape) != (1, 1):
        raise AssertionError(f"a mesh {tuple(mesh.shape)}, want (1, 1)")
    rules = MeshRules(mesh, cfg=cfg)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    rec: dict = {"card": card_line() if dev == "cuda" else "cpu",
                 "arch": cfg.name, "layers": cfg.n_layers}

    api = get_model(dataclasses.replace(cfg, use_flash_kernel=True), dev)
    b, s = prefill_shape
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s),
                                               dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    params = api.init(gen())
    sync()
    t = time.perf_counter()
    want = build_prefill_step(api)(params, batch)
    sync()
    meshless_ms = (time.perf_counter() - t) * 1e3
    shard_params(params, rules)
    sync()
    fa.flash_attention_fwd.launches = 0      # the main path: counts from 0
    t = time.perf_counter()
    got = build_prefill_step(api, rules=rules)(params, batch)
    sync()
    rec["prefill"] = {"launches": fa.flash_attention_fwd.launches,
                      "bit_identical": torch.equal(_local(got), want),
                      "shape": list(got.shape), "meshless_ms": meshless_ms,
                      "mesh_ms": (time.perf_counter() - t) * 1e3}
    log(f"[moe_mesh] prefill B={b} S={s}: " + json.dumps(rec["prefill"]))
    if rec["prefill"]["launches"] != cfg.n_layers:
        raise AssertionError(f"{rec['prefill']['launches']} flash launches "
                             f"under the mesh, want {cfg.n_layers}")
    if not rec["prefill"]["bit_identical"]:
        raise AssertionError("Moonlight's prefill under the mesh is not the "
                             "meshless one bit for bit")
    del want, got, params
    if dev == "cuda":
        torch.cuda.empty_cache()

    api = get_model(cfg, dev)
    b, s = train_shape
    tbatch = api.input_specs(ShapeSpec("moe_mesh_train", s, b, "train"),
                             abstract=False, seed=0)
    runs = {}
    for tag, r in (("meshless", None), ("mesh", rules)):
        params = api.init(gen())
        step = build_train_step(api, TrainStepConfig(), rules=r)
        if r is not None:
            shard_params(params, r)
        opt = opt_state_for(params)
        losses, ms = [], []
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            t = time.perf_counter()
            _, opt, m = step(params, opt, tbatch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t) * 1e3)
        runs[tag] = {"losses": losses, "step_ms": ms,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()
                     if dev == "cuda" else None,
                     "digests": _leaf_digests(params, opt)}
        del params, opt, step, m
        if dev == "cuda":
            torch.cuda.empty_cache()
    plain, sharded = runs["meshless"], runs["mesh"]
    mismatched = [k for k, h in plain["digests"].items()
                  if sharded["digests"].get(k) != h]
    rec["train"] = {k: {"losses": r["losses"], "step_ms": r["step_ms"],
                        "max_memory_allocated": r["max_memory_allocated"]}
                    for k, r in runs.items()}
    rec["train"]["leaves"] = len(plain["digests"])
    rec["train"]["mismatched_leaves"] = mismatched
    rec["seconds"] = time.perf_counter() - t0
    log(f"[moe_mesh] train B={b} S={s}: " + json.dumps(rec["train"]))
    log(f"[phase] moe_mesh {rec['seconds']:.2f} s")
    if plain["losses"] != sharded["losses"] or mismatched or \
            set(plain["digests"]) != set(sharded["digests"]):
        raise AssertionError("Moonlight's steps under the mesh are not the "
                             f"meshless ones bit for bit: {rec['train']}")
    if dev == "cuda" and sharded["max_memory_allocated"] > (
            1 + MESH_MEMORY_TOL) * plain["max_memory_allocated"]:
        raise AssertionError("Moonlight's steps under the mesh allocated "
                             f"more than {1 + MESH_MEMORY_TOL} x the "
                             "meshless ones")
    return rec


def serve_reference(runs: dict) -> dict:
    """What ``serve_mesh`` holds the engine on the mesh to, from the serve
    phase's meshless runs (``serve(...)["runs"]``): the golden tokens, and
    the budgeted run's decision trace, transfer bytes and KV launches, in
    JSON's types."""
    bud = runs["budgeted"]
    return {"golden": runs["golden"]["out"], "budget": bud["budget"],
            "trace": [list(k) for k in bud["trace"]], "moved": bud["moved"],
            "launches": bud["launches"]}


def serve_mesh(ref_path: str, device: str = "cuda", arch: str = ARCH,
               reduced: bool = False) -> dict:
    """``ServingEngine(rules=...)`` on the (1, 1) host mesh, full-width
    TinyLlama-1.1B, the serve phase's trace and budget (batched
    transfers), against the serve phase's meshless runs
    (``serve_reference``, a JSON file at ``ref_path``): its tokens are the
    golden run's, its decision trace, each transfer's bytes and its KV
    launches the meshless budgeted run's, with evictions and no OOM.
    Runs in the distribution phase's process."""
    t0 = time.perf_counter()
    dev = device
    with open(ref_path) as f:
        ref = json.load(f)
    init_world(dev)
    rules = MeshRules(make_host_mesh(device=dev), cfg=get_config(arch))
    eng = ServingEngine(arch, reduced=reduced, max_sequences=MAX_SEQUENCES,
                        max_len=MAX_LEN, seed=0, device=dev, rules=rules)
    reqs = make_trace("poisson", N_REQUESTS, seed=0, prompt_len=PROMPT_LEN,
                      gen_len=GEN_LEN)
    budget = eng.bytes_per_token * (2 * MAX_LEN + 2)
    mem = MemoryEngine(profile=MachineProfile(), capacity_bytes=budget,
                       trace=True)
    moved, xfer = [], eng._xfer
    eng._xfer = lambda fn: moved.append(xfer(fn)) or moved[-1]
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    kbc.kv_block_gather.launches = 0         # the main path: counts from 0
    kbc.kv_block_scatter.launches = 0
    t = time.perf_counter()
    rep, out = eng.serve(reqs, budget_bytes=budget, schedule=True,
                         block_tokens=4, engine=mem, batch_transfers=True)
    sync()
    rec = {"card": card_line() if dev == "cuda" else "cpu", "budget": budget,
           "tokens_equal_golden": out == ref["golden"],
           "trace_equal": [list(k) for k in mem.trace.keys()]
           == ref["trace"],
           "moved_equal": moved == ref["moved"],
           "moved_bytes": sum(moved), "transfers": len(moved),
           "launches": {"kv_block_gather": kbc.kv_block_gather.launches,
                        "kv_block_scatter": kbc.kv_block_scatter.launches},
           "meshless_launches": ref["launches"],
           "oom_events": rep.oom_events, "evictions": rep.evictions,
           "wall_s": time.perf_counter() - t,
           "cache": sorted({type(x).__name__ for x in
                            serving_engine.tree_leaves(eng.cache)}),
           "seconds": time.perf_counter() - t0}
    log("[serve_mesh] " + json.dumps(rec))
    log(f"[phase] serve_mesh {rec['seconds']:.2f} s")
    if budget != ref["budget"] or not (
            rec["tokens_equal_golden"] and rec["trace_equal"]
            and rec["moved_equal"]):
        raise AssertionError("the engine on the mesh departs from the "
                             f"meshless engine: {rec}")
    if eng.rules is None or rec["cache"] != ["DTensor"]:
        raise AssertionError(f"the mesh engine's cache is {rec['cache']}, "
                             "not placed on the mesh")
    if dev == "cuda" and (rec["launches"] != ref["launches"] or min(
            rec["launches"].values()) <= 0):
        raise AssertionError(f"KV launches on the mesh {rec['launches']}, "
                             f"meshless {ref['launches']}")
    if rep.oom_events != 0 or rep.evictions <= 0:
        raise AssertionError(f"the mesh engine's run: oom_events "
                             f"{rep.oom_events}, evictions {rep.evictions}")
    return rec


# ----------------------------------------------------------------------
# the dry run
# ----------------------------------------------------------------------
DRYRUN_CELLS = [(ARCH, "train_4k"), (ARCH, "prefill_32k"),
                (ARCH, "decode_32k"), (MOE_ARCH, "decode_32k"),
                (SSM_ARCH, "long_500k"), (MOE_ARCH, "train_4k"),
                ("gemma-2b", "train_4k")]
# the cells whose per-device peak must fit the card (the reference's own
# accounting fits them in 80 GB)
DRYRUN_FITS = [(ARCH, "train_4k"), (MOE_ARCH, "train_4k"),
               ("gemma-2b", "train_4k")]
DRYRUN_PEAK_TOL = 0.10
DRYRUN_DECODE_STEPS = 4
DRYRUN_DECODE_LEN = 2048


def dryrun_cells() -> list:
    """``launch.dryrun.run_cell`` for DRYRUN_CELLS on the 16 x 16 mesh, as
    rank 0 of a 512-rank ``fake`` world in this process (a fresh one: the
    fake world cannot share a process with an NCCL world); each record's
    peak, FLOPs, dominant term and collective mix.  Gates: finite,
    positive FLOPs, a peak at least the arguments, and the DRYRUN_FITS
    cells within the card's memory."""
    from repro_torch.launch import dryrun
    out = []
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, False)
        r = rec["roofline"]
        summary = {
            "arch": arch, "shape": shape, "mesh": rec["mesh"],
            "seconds": rec["compile_seconds"],
            "per_device_peak_bytes": rec["per_device_peak_bytes"],
            "per_device": rec["per_device"],
            "fits_device_memory": rec["fits_device_memory"],
            "flops": rec["cost"]["flops"],
            "bytes_accessed": rec["cost"]["bytes_accessed"],
            "model_flops": r["model_flops"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "dominant": r["dominant"],
            "roofline_s": {k: r[k] for k in ("compute_s", "memory_s",
                                             "collective_s")},
            "collectives": {k: {"count": v["count"], "bytes": v["bytes"]}
                            for k, v in rec["collectives"].items()}}
        log("[dryrun] cell " + json.dumps(summary))
        if not (math.isfinite(summary["flops"]) and summary["flops"] > 0):
            raise AssertionError(f"{arch} x {shape}: FLOPs {summary['flops']}")
        if rec["per_device_peak_bytes"] < rec["per_device"]["arguments"]:
            raise AssertionError(f"{arch} x {shape}: a peak below the "
                                 "arguments")
        if (arch, shape) in DRYRUN_FITS and not rec["fits_device_memory"]:
            raise AssertionError(f"{arch} x {shape}: a per-device peak of "
                                 f"{rec['per_device_peak_bytes']} B does "
                                 "not fit the card")
        out.append(summary)
    return out


def _dryrun_steps(api, params, rules, meta: bool) -> dict:
    """The accounting check's three steps on ``params`` (``meta`` shells
    or the card's), each as ``(step, args)``: the smoke's train step
    (TRAIN_B x TRAIN_S), the prefill (PREFILL_B x PREFILL_S) and
    DRYRUN_DECODE_STEPS decode steps against a DRYRUN_DECODE_LEN cache.
    Under ``rules`` the batches are placed first (the reference's
    ``in_shardings``)."""
    from repro_torch.launch.dryrun import place_batch

    def placed(batch):
        return batch if rules is None else place_batch(rules, batch)
    train = ShapeSpec("smoke_train", TRAIN_S, TRAIN_B, "train")
    pre = ShapeSpec("smoke_prefill", PREFILL_S, PREFILL_B, "prefill")
    dec = ShapeSpec("smoke_decode", DRYRUN_DECODE_LEN, PREFILL_B, "decode")
    opt = opt_state_for(params, abstract=meta)
    cache = (api.abstract_cache if meta else api.init_cache)(
        PREFILL_B, DRYRUN_DECODE_LEN)
    batches = [api.decode_input_specs(dec, abstract=meta, seed=i)
               for i in range(DRYRUN_DECODE_STEPS)]
    serve = build_serve_step(api, rules=rules)

    def decode(params, cache, batches):
        for i, b in enumerate(batches):
            logits, cache = serve(params, cache, b, i)
        return logits, cache
    return {
        "train": (build_train_step(api, TrainStepConfig(), rules=rules),
                  (params, opt, placed(api.input_specs(
                      train, abstract=meta, seed=0)))),
        "prefill": (build_prefill_step(api, rules=rules),
                    (params, placed(api.input_specs(pre, abstract=meta,
                                                    seed=0)))),
        "decode": (decode, (params, cache, batches))}


def dryrun_card(device: str = "cuda", cfg=None) -> dict:
    """The dry run's accounting against the card: full-width
    TinyLlama-1.1B's train step, prefill and decode steps (the config's
    default path, plain attention, as on ``meta``), meshless and under the
    (1, 1) host mesh of a world of one, each accounted on ``meta`` shells
    and again on the card's tensors after a warm-up run.  Gates: the FLOP
    counts equal on both, and equal meshless and under the mesh; the
    ledger's predicted peak within DRYRUN_PEAK_TOL of the allocator's
    (``max_memory_allocated`` over the step less ``memory_allocated``
    before it, plus the arguments' bytes); no collective under the mesh.
    Each step's time (CUDA events, 2 runs, without the accounting) is
    printed beside the roofline's compute and memory seconds.  Runs in a
    fresh process, after ``distribution`` (its world); ``device`` and
    ``cfg`` rehearse it on the CPU (no allocator gate there)."""
    from repro_torch.launch.dryrun import account
    deterministic()
    dev = device
    cfg = cfg or get_config(ARCH)
    api = get_model(cfg, dev)
    init_world(dev)
    mesh = make_host_mesh(device=dev)
    rules = MeshRules(mesh, cfg=cfg)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    counters = (fa.flash_attention_fwd, ss.ssd_intra_chunk_fwd)
    for k in counters:
        k.launches = 0                   # the phase's path: counts from 0
    rec: dict = {"card": card_line() if dev == "cuda" else "cpu",
                 "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    failures = []
    for mode, r in (("meshless", None), ("mesh", rules)):
        shell = api.shell()
        if r is not None:
            shard_params(shell, r)
        metas = _dryrun_steps(api, shell, r, meta=True)
        params = api.init(torch.Generator(device=dev).manual_seed(0))
        if r is not None:
            shard_params(params, r)
        cards = _dryrun_steps(api, params, r, meta=False)
        for kind, (step, args) in metas.items():
            _, acc_meta, meta_s = account(step, args)
            cstep, cargs = cards[kind]
            cstep(*cargs)                               # warm-up
            if kind == "decode":
                for t in pytree.tree_leaves(cargs[1]):
                    t.zero_()
            sync()
            before = torch.cuda.memory_allocated() if dev == "cuda" else 0
            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()
            out, acc, _ = account(cstep, cargs)
            sync()
            del out
            measured = (torch.cuda.max_memory_allocated() - before
                        + acc.arg_bytes) if dev == "cuda" else None
            ms = events_ms(lambda: cstep(*cargs), 2) \
                if dev == "cuda" else None
            one = {
                "flops_meta": acc_meta.flops, "flops_card": acc.flops,
                "predicted_peak": acc_meta.peak_bytes,
                "card_ledger_peak": acc.peak_bytes,
                "allocator_peak": measured,
                "arguments": acc_meta.arg_bytes,
                "peak_rel_err": (acc_meta.peak_bytes - measured) / measured
                if measured else None,
                "collectives_meta": len(acc_meta.collectives),
                "collectives_card": len(acc.collectives),
                "meta_s": meta_s, "ms": ms,
                "compute_s": acc_meta.flops / BF16_FLOPS_PER_S,
                "memory_s": acc_meta.bytes_accessed / HBM_BYTES_PER_S}
            rec[f"{mode}:{kind}"] = one
            log(f"[dryrun] {mode} {kind}: " + json.dumps(one))
            if acc_meta.flops != acc.flops:
                failures.append(f"{mode} {kind}: FLOPs {acc_meta.flops} on "
                                f"meta, {acc.flops} on the card")
            if measured and abs(one["peak_rel_err"]) > DRYRUN_PEAK_TOL:
                failures.append(f"{mode} {kind}: predicted peak "
                                f"{acc_meta.peak_bytes} B, the allocator's "
                                f"{measured} B")
            if r is not None and (acc_meta.collectives or acc.collectives):
                failures.append(f"{mode} {kind}: collectives on the (1, 1) "
                                f"mesh: {acc_meta.collectives} "
                                f"{acc.collectives}")
        del cards, params, metas, shell
        if dev == "cuda":
            torch.cuda.empty_cache()
    for kind in ("train", "prefill", "decode"):
        if rec[f"mesh:{kind}"]["flops_meta"] != \
                rec[f"meshless:{kind}"]["flops_meta"]:
            failures.append(f"{kind}: the (1, 1) mesh counts other FLOPs "
                            "than meshless")
    rec["launches"] = {k.__name__: k.launches for k in counters}
    log("[dryrun] launches on the path (plain attention by default): "
        + json.dumps(rec["launches"]))
    if failures:
        raise AssertionError("dry-run accounting: " + "; ".join(failures))
    return rec


@contextlib.contextmanager
def counting_swaps(counts: collections.Counter):
    """While active, count the executor's host copies (``out_``) and host
    fetches (``in_``), compressed and plain, into ``counts``."""
    cls = tensile_executor.FxExecutor
    to_host, fetch = cls._to_host, cls._host_fetch

    def counted_to_host(self, val, compressed):
        counts["out_compressed" if compressed else "out_plain"] += 1
        return to_host(self, val, compressed)

    def counted_fetch(self, st):
        rec = self.host[st]
        if rec.compressed:
            counts["in_compressed"] += 1
            q, s, _ = rec.data
            if (q.numel() + 4 * s.numel()
                    > tensile_executor.ZERO_COPY_MAX_BYTES):
                counts["in_compressed_copied"] += 1
        else:
            counts["in_plain"] += 1
        return fetch(self, st)

    cls._to_host, cls._host_fetch = counted_to_host, counted_fetch
    try:
        yield counts
    finally:
        cls._to_host, cls._host_fetch = to_host, fetch


def _spy_quant(fn, shapes):
    def call(x, *args, **kw):
        shapes[(tuple(x.shape), str(x.dtype).replace("torch.", ""))] += 1
        return fn(x, *args, **kw)
    return call


def _spy(fn, name, shapes):
    def call(leaves, idx, *rest, **kw):
        shapes[(name, tuple(tuple(x.shape) for x in leaves),
                tuple(str(x.dtype) for x in leaves), len(idx))] += 1
        return fn(leaves, idx, *rest, **kw)
    return call


def timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name} {time.perf_counter() - t0:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--fresh"]:
        # a child of in_fresh_process: the last line is the phase's result
        print(json.dumps(FRESH_PHASES[sys.argv[2]](*json.loads(sys.argv[3]))))
        return 0
    deterministic()

    log(card_line())
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    built = timed("build", build)
    flash_build = build_report(built, "flash_attention", "flash_fwd")
    ssd_build = build_report(built, "ssd_scan", "ssd_fwd", ("HGMMA", "HMMA"))

    link = timed("host_link", measure_host_link)
    log("[host_link] " + json.dumps(link))

    width = 22 * MAX_LEN * 4 * 64          # one slot's row of a KV leaf
    worst = timed("check_kernels", check_kernels, [
        (MAX_SEQUENCES, width, torch.bfloat16, k) for k in (2, 3, 4)] + [
        (MAX_SEQUENCES, width, torch.float32, 3),
        (7, 1001, torch.bfloat16, 3),        # 2-byte rows: element path
        (5, 333, torch.float32, 2),          # 4-byte rows
        (6, 77, torch.uint8, 4)])            # 1-byte rows
    worst = max(worst, timed("check_leaves", check_leaves, [
        (TINYLLAMA_LEAVES, 2, 0), (TINYLLAMA_LEAVES, 3, 0),
        (TINYLLAMA_LEAVES[:1], 2, 0), (MAMBA_LEAVES, 2, 0),
        (MAMBA_LEAVES, 3, 0), (MAMBA_LEAVES[3:], 2, 0),
        (ODD_LEAVES, 3, 0), (ODD_LEAVES, 3, 1)]))
    timed("check_decode", check_decode_on_small_input)

    # the batched transfer as the engine makes it, K = 2 (most batched
    # transfers of both serves): TinyLlama's two leaves, and Mamba-2's fp32
    # state leaf, 99 % of its bytes
    kv_times = {
        "tinyllama": timed("time_leaves", time_leaves, TINYLLAMA_LEAVES, 2),
        "mamba2_state": timed("time_leaves_state", time_leaves,
                              MAMBA_LEAVES[3:], 2)}
    for name, t in kv_times.items():
        log(f"[time] kv {name}: " + json.dumps(t))
    torch.cuda.empty_cache()

    result = timed("serve", serve, MachineProfile())
    timed("profile_decode", profile_decode, result["eng"])
    flash_errs = timed("check_flash", check_flash)
    pre = timed("prefill", prefill, result["eng"])
    timed("check_forward", check_forward_on_small_input)
    timed("train", train, result["eng"])
    timed("check_train_step", check_train_step_on_small_input)
    tf = timed("time_flash", time_flash)
    tf128 = timed("time_flash_d128", time_flash, FLASH_D128, False)
    bud = result["runs"]["budgeted"]
    serve_launches = bud["launches"]
    # the meshless runs that serve_mesh holds the engine on the mesh to
    serve_ref = os.path.join(tempfile.mkdtemp(prefix="serve-ref-"),
                             "serve_ref.json")
    with open(serve_ref, "w") as f:
        json.dump(serve_reference(result["runs"]), f)
    del result, bud
    torch.cuda.empty_cache()

    # Mamba-2 780M: the SSD kernel, then serve, prefill and train
    ssd_errs = timed("check_ssd", check_ssd)
    ssm = timed("serve_ssm", serve, MachineProfile(), SSM_ARCH)
    ssm_serve = ssm["runs"]["budgeted"]
    if not any("torch.float32" in dtypes and k > 1
               for (_, _, dtypes, k) in ssm_serve["shapes"]):
        raise AssertionError("no batched launch moved the fp32 SSM state")
    gap = (ssm_serve["max_memory_allocated"]
           - ssm["runs"]["golden"]["max_memory_allocated"])
    state_row = max(t.numel() * t.element_size() for t in
                    serving_engine.tree_leaves(ssm["eng"].cache)
                    ) // MAX_SEQUENCES
    if gap > 2 * state_row + SSM_SWAP_SLACK:
        raise AssertionError(f"the budgeted Mamba-2 serve allocated {gap} B "
                             "over the golden run: more than one batched "
                             f"transfer's rows (2 x {state_row} B and "
                             f"{SSM_SWAP_SLACK} B)")
    restore = dict(zip((ARCH, SSM_ARCH), timed(
        "profile_restore", in_fresh_process, "phases",
        [["profile_restore", [arch]] for arch in (ARCH, SSM_ARCH)])))
    timed("profile_decode_ssm", profile_decode, ssm["eng"])
    timed("check_decode_ssm", check_decode_on_small_input, SSM_ARCH)
    ssm_pre = timed("prefill_ssm", prefill, ssm["eng"],
                    ss.ssd_intra_chunk_fwd, _mamba_mix, SSM_PREFILL_REL_TOL)
    timed("check_forward_ssm", check_forward_on_small_input, SSM_ARCH)
    timed("train_ssm", train, ssm["eng"])
    timed("check_train_step_ssm", check_train_step_on_small_input, SSM_ARCH)
    ts = timed("time_ssd", time_ssd)
    del ssm
    torch.cuda.empty_cache()

    quant = timed("check_quant", check_quant)
    quant_big = timed("time_quant", time_quant, QUANT_BIG, torch.float32,
                      link)
    sweep = timed("quant_cta_sweep", quant_cta_sweep, link)
    ladder = timed("quant_swap_in_ladder", quant_swap_in_ladder)
    timed("tensile_mlp", tensile_mlp)
    tt = timed("tensile_train", tensile_train, link,
               quant_big["quantize_source_bytes_per_s"])
    # both kernels against their plain versions at every shape the main
    # path quantized
    quant_main = timed("check_quant_main_path", check_quant, [
        (shape, getattr(torch, dtype))
        for shape, dtype in tt["quantized_shapes_raw"]])
    # the kernels' times at the main path's most quantized shape
    (shape, dtype), _ = max(tt["quantized_shapes_raw"].items(),
                            key=lambda kv: (kv[1], math.prod(kv[0][0])))
    qt = timed("time_quant", time_quant, shape, getattr(torch, dtype), link)
    # the SSD and quant kernels' device times, in one fresh process (whose
    # traces lose no events): the SSD wrapper at the prefill's shape, the
    # quant pair at 64 MiB fp32 and at the main path's shape
    ts_dev, quant_big_dev, qt_dev = timed(
        "device_ms", in_fresh_process, "phases", [
            ["ssd_device_ms", []],
            ["quant_device_ms", [QUANT_BIG, "float32"]],
            ["quant_device_ms", [shape, dtype]]])
    log("[time] ssd device ms " + json.dumps(ts_dev))
    log("[time] quant device ms at 64 MiB fp32 " + json.dumps(quant_big_dev))
    log("[time] quant device ms " + json.dumps(qt_dev))
    torch.cuda.empty_cache()

    # the multi-job runtime, in a fresh process: two full-width train jobs
    # and a budgeted serve job under one controller, then the splice.  The
    # pinned host memory this process's swaps left cached goes back first:
    # the two processes share the host's memory
    empty_host_cache = getattr(torch._C, "_host_emptyCache", None)
    if empty_host_cache is not None:
        empty_host_cache()
    log(f"[multi_job] peak host memory of this process: "
        f"{host_peak_bytes()} B")
    mj = timed("multi_job", lambda: in_fresh_process(
        "multi_job", link, timeout=900))

    # the experience plane: the store's first run, then a warm run in a
    # second process from the same store, outside the checkout
    store_dir = tempfile.mkdtemp(prefix="tensile-experience-")
    service_root = tempfile.mkdtemp(prefix="tensile-service-")
    try:
        t0 = time.perf_counter()
        cold = in_fresh_process("experience_cold", link, store_dir,
                                timeout=900)
        cold_s = time.perf_counter() - t0
        log(f"[phase] experience_cold {cold_s:.2f} s")
        # the service plane: this process submits through the inbox; a
        # daemon over the same store runs the jobs in the warm process
        service = service_submit(service_root, cold["handoff"],
                                 mj["multi_job"])
        warm = in_fresh_process("experience_warm", link, store_dir,
                                cold["handoff"], "cuda", None, service,
                                timeout=900)
        warm_s = time.perf_counter() - t0 - cold_s
        log(f"[phase] experience_warm (and the service daemon) "
            f"{warm_s:.2f} s")
        svc = timed("service", service_gates, service, cold, warm)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
        shutil.rmtree(service_root, ignore_errors=True)
    log("[experience] " + json.dumps({
        "command_s": {"cold": cold_s, "warm": warm_s},
        "first_plan_s": {"cold_A": cold["A"]["first_plan_s"],
                         "cold_B": cold["B"]["first_plan_s"],
                         "warm_A": warm["A"]["first_plan_s"]},
        "predicted": {"cold_A": cold["A"]["predicted"],
                      "cold_B": cold["B"]["predicted"],
                      "warm_A": warm["A"]["predicted"]},
        "measured_peak": {"cold_A": cold["A"]["measured_peak"],
                          "cold_B": cold["B"]["measured_peak"],
                          "warm_A": warm["A"]["measured_peak"]},
        "peak_drift": {"cold_A": cold["A"]["drift"]["peak_drift"],
                       "cold_B": cold["B"]["drift"]["peak_drift"],
                       "warm_A": warm["A"]["drift"]["peak_drift"]},
        "peak_split": warm["peak_split"], "bandwidth": warm["bandwidth"],
        "mlp": cold["mlp"],
        "store_bytes": warm["store_bytes"]}))

    # the training launcher at full width, in a fresh process: TENSILE's
    # decisions as a remat policy, moments on the host, int8 gradients,
    # prefetch, checkpoints and a restart, then the entry point
    tl = timed("train_launcher", lambda: in_fresh_process(
        "train_launcher", timeout=900))
    log("[train_launcher] " + json.dumps(tl))

    # the MoE slice, in a fresh process on an empty card: Moonlight-16B-A3B
    # served, prefilled and trained under TENSILE, Kimi-K2's prefix and
    # shared expert, the reduced MoE and hybrid checks
    torch.cuda.empty_cache()
    log(f"[moe] this process holds {torch.cuda.memory_allocated()} B of "
        "the card")
    mo = timed("moe", lambda: in_fresh_process("moe", link, timeout=900))

    # the whisper slice, in a fresh process: whisper-base at full width on
    # 30-s windows, prefilled, decoded, trained and run under TENSILE
    wh = timed("whisper", lambda: in_fresh_process("whisper", link,
                                                   timeout=600))

    # the dry run's cells on a 512-rank fake world (host only), in a fresh
    # process beside the next one; then distribution and the dry run's
    # accounting against the card in one fresh process: a world of one,
    # the host mesh and full-width TinyLlama under its rules, bit for bit
    # against meshless, then each step accounted on meta and on the card
    t0 = time.perf_counter()
    cells_proc = start_fresh("dryrun_cells")
    try:
        dist_rec, moe_mesh_rec, serve_mesh_rec, dry_card = timed(
            "distribution_and_dryrun_card", lambda: in_fresh_process(
                "phases", [["distribution", []], ["moe_mesh", []],
                           ["serve_mesh", [serve_ref]],
                           ["dryrun_card", []]], timeout=900))
    finally:
        shutil.rmtree(os.path.dirname(serve_ref), ignore_errors=True)
    log("[distribution] " + json.dumps(dist_rec))
    dry_cells = finish_fresh(cells_proc, "dryrun_cells", timeout=600)
    log(f"[phase] dryrun (cells beside the card check) "
        f"{time.perf_counter() - t0:.2f} s")
    log("[dryrun] " + json.dumps({"cells": dry_cells, "card": dry_card}))

    kernels = []
    for name in ("kv_block_gather", "kv_block_scatter"):
        tl = kv_times["tinyllama"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": serve_launches[name],
            "max_abs_err": worst,
            "ms": tl[name]["ms"], "plain_ms": tl[name]["plain_ms"],
            "bound_ms": tl["bound_ms"], "bound_by": "bytes",
            # no one call moves two leaves: one per leaf, back to back
            "library_ms": tl[name]["library_ms"], "library_calls": 2,
            "device_ms": tl[name]["device_ms"],
            "library_device_ms": tl[name]["library_device_ms"],
            "shape": {"leaves": tl["leaves"], "k": tl["k"]},
            "launches_serve_ssm": ssm_serve["launches"][name],
            "launches_multi_job": mj["multi_job"]["launches"][name],
            "launches_service": svc["launches"][name],
            "mamba2_state": kv_times["mamba2_state"][name],
            "mamba2_state_bound_ms": kv_times["mamba2_state"]["bound_ms"],
            "restore_device_busy_ms": {
                arch: r["device_busy_ms"] for arch, r in restore.items()},
            "launches_moe_serve": mo["serve"]["budgeted"]["launches"][name],
            "launches_serve_mesh": serve_mesh_rec["launches"][name],
            "moonlight": mo["kv"][name],
            "moonlight_bound_ms": mo["kv"]["bound_ms"],
            "max_abs_err_moonlight": mo["kv_max_abs_err"]})
    b, sq, _, h, kvh, d, _, _, _ = FLASH_PREFILL
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": REPLACES["flash_attention_fwd"],
        "launches": pre["launches"],
        "max_abs_err": flash_errs[FLASH_PREFILL],
        "ms": tf["ms"], "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"], "bound_by": tf["bound_by"],
        "library_ms": tf["library_ms"], "device_ms": pre["kernel_device_ms"],
        "tflops": tf["tflops"], "library_tflops": tf["library_tflops"],
        "tolerance": FLASH_TOL[torch.bfloat16],
        "shape": [b, sq, h, kvh, d, "bfloat16", "causal"],
        **flash_build,
        "d128": {k: tf128[k] for k in ("ms", "library_ms", "bound_ms",
                                       "tflops", "library_tflops")},
        "launches_moe_prefill": mo["prefill"]["launches"],
        "moonlight": {**{k: mo["flash_moonlight"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "tflops")}, "device_ms": mo["prefill"]["kernel_device_ms"],
            "max_abs_err": mo["flash_max_abs_err"]["moonlight"],
            "shape": list(FLASH_MOONLIGHT[:6]) + ["bfloat16", "causal"]},
        "launches_whisper_prefill": wh["prefill"]["launches"],
        "launches_mesh_prefill": dist_rec["prefill"]["launches"],
        "launches_moe_mesh_prefill": moe_mesh_rec["prefill"]["launches"],
        "whisper": {**{k: wh["flash"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "tflops")}, "device_ms": wh["prefill"]["kernel_device_ms"],
            "max_abs_err": wh["flash_max_abs_err"]["bf16"],
            "max_abs_err_fp32": wh["flash_max_abs_err"]["fp32"],
            "shape": list(FLASH_WHISPER[:6]) + ["bfloat16", "causal"]},
        "launches_kimi_prefill": mo["kimi"]["flash_launches"],
        "kimi_d112": {**{k: mo["flash_kimi"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "tflops")}, "max_abs_err": mo["flash_max_abs_err"]["kimi"],
            "shape": list(FLASH_KIMI[:6]) + ["bfloat16", "causal"]}})
    for name in ("quantize_blocked", "dequantize_blocked"):
        kernels.append({
            "name": name, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": REPLACES[name], "launches": tt["launches"][name],
            "max_abs_err": max(quant["max_abs_err"],
                               quant_main["max_abs_err"]),
            "ms": qt[name]["ms"], "plain_ms": qt[name]["plain_ms"],
            "bound_ms": qt[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "device_ms": qt_dev[name],
            "shape": qt[name]["shape"], "dtype": qt[name]["dtype"],
            "swap_ms": qt[name]["swap_ms"],
            "swap_device_ms": qt_dev["swap_out" if name.startswith("q")
                                     else "swap_in"],
            "link_bound_ms": qt[name]["link_bound_ms"],
            "launches_per_swap": tt["launches_per_swap"][name],
            "stray_sentinel_bytes": quant["stray_sentinel_bytes"]
            + quant_main["stray_sentinel_bytes"],
            "ms_64mib_fp32": quant_big[name]["ms"],
            "device_ms_64mib_fp32": quant_big_dev[name],
            "bound_ms_64mib_fp32": quant_big[name]["bound_ms"],
            "swap_ms_64mib_fp32": quant_big[name]["swap_ms"],
            "link_bound_ms_64mib_fp32": quant_big[name]["link_bound_ms"],
            "host_ctas": sweep["host_ctas"],
            "zero_copy_max_bytes": ladder["zero_copy_max_bytes"]})
    b, nc, q, h, p, n, _ = SSD_PREFILL
    kernels.append({
        "name": "ssd_intra_chunk_fwd", "route": "cuda",
        "source": SSD_SOURCE, "replaces": REPLACES["ssd_intra_chunk_fwd"],
        "launches": ssm_pre["launches"],
        "max_abs_err": ssd_errs[SSD_PREFILL]["max_abs_err"],
        "ms": ts["ms"], "plain_ms": ts["plain_ms"],
        "bound_ms": ts["bound_ms"], "bound_by": ts["bound_by"],
        "library_ms": None, "device_ms": ssm_pre["kernel_device_ms"],
        "device_ms_alone": ts_dev["device_ms"],
        "ops_bound_ms": ts["ops_bound_ms"],
        "bytes_bound_ms": ts["bytes_bound_ms"],
        "fp32_bound_ms": ts["fp32_bound_ms"], "tflops": ts["tflops"],
        "bound_share": ts["bound_share"],
        "fp32_bound_share": ts["fp32_bound_share"],
        "tolerance": SSD_TOL,
        "tolerance_share": max(e["tolerance_share"]
                               for e in ssd_errs.values()),
        "tolerance_share_prefill": ssd_errs[SSD_PREFILL]["tolerance_share"],
        "max_abs_err_sweep": max(ssd_errs[sh]["max_abs_err"]
                                 for sh in SSD_SWEEP),
        "shape": [b, nc, q, h, p, n, "bfloat16"], **ssd_build})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phases(calls: list) -> list:
    """Several of FRESH_PHASES in one fresh process, in order: each call a
    ``[name, args]`` pair; one process start for all of them."""
    return [FRESH_PHASES[name](*args) for name, args in calls]


FRESH_PHASES = {"phases": phases,
                "whisper": whisper,
                "distribution": distribution,
                "moe_mesh": moe_mesh,
                "serve_mesh": serve_mesh,
                "dryrun_cells": dryrun_cells,
                "dryrun_card": dryrun_card,
                "moe": moe,
                "train_launcher": train_launcher,
                "experience_cold": experience_cold,
                "experience_warm": experience_warm,
                "multi_job": multi_job,
                "profile_restore": profile_restore,
                "quant_device_ms": quant_device_ms,
                "ssd_device_ms": ssd_device_ms}

if __name__ == "__main__":
    raise SystemExit(main())
