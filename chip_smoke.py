#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

  1. environment  card name and power limit (nvidia-smi), torch/CUDA
                  versions, compute capability 9.0 asserted;
  2. build        the CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
                  one nvcc per source, all started together; ptxas's
                  registers, shared memory and spills of the flash kernels
                  (``flash_gqa_sm90.cu``, and ``flash_gqa.cu``'s f32
                  kernels, the tensor-core fwd_tf32_kernel (at 64, 80 and
                  128, each required in the report), dq_wgmma_kernel,
                  dkv_wgmma_kernel, dq_tf32_kernel and dkv_tf32_kernel
                  among them) printed, and no spill and no
                  serialized wgmma (ptxas's C7515 / C7520 notes) allowed
                  there;
  3. kernels      each kernel against its plain PyTorch version on the card:
                  the update pair (K1/K2) at the ResNet path's shape (C = 20
                  clients, N = 1,249,956, shared server delta), at
                  per-client delta, C = 1, ragged N and bf16, and at the LM
                  path's C = 1, N = 999,826,048 (gemma3-1b), and rank 0's
                  tile range of m = 2 and 4 model ranks (timed); rmsnorm (K4)
                  and flash_gqa forward / dq / dk-dv (K5-K7) at the LM
                  slice's shapes (B = 2, S = 2048, D = 256), G = 1 and 4,
                  window on and off, softcap on and off, f32 and bf16, plus
                  bf16 at D = 64 and 128, a ragged S = 1,000 and S = 40, and
                  zamba2's D = 80 (H = KV = 32, bf16 and f32, a masked
                  bf16 case and the narrow kernels' edges at D = 80, 64
                  and 128: S = 40, 1,040 and 1,100, window 512; timed too, beside SDPA at D = 80 and at phase 19's
                  rank, H = KV = 16), and phases
                  13-15's shapes: granite-moe's training (H = 16 over KV =
                  8, D = 64, and its sum pass), internvl2's and musicgen's
                  prefill (B = 4, S = 1,024; D = 128 and 64) and
                  internvl2's training (B = 2, S = 2,048, D = 128; timed
                  too) (bf16 K5-K7 run on the tensor cores,
                  ``flash_gqa_sm90.cu``: at D = 64, 80 and 128 K5 on the
                  persistent ``fwd_narrow_kernel``, K6 and K7 on
                  ``dq_narrow_kernel`` and ``dkv_narrow_kernel``;
                  K6's dq and K7's dk/dv held bitwise across two launches,
                  in f32 before their final rounding within half an ulp,
                  and K7's sum pass bitwise against its plain version); f32
                  K5-K7 (``flash_gqa.cu``: at D = 64, 80 and 128 on the
                  tensor cores, three TF32 products a product, K5 on
                  mma.sync, K6 and K7 on wgmma at 64 and mma.sync at 80
                  and 128; K5 held to ``TF32_FWD_TOL``, K6 and K7 to
                  ``TF32_BWD_TOL``) at granite-moe's and internvl2's
                  training shapes, zamba2's, a ragged S with window and
                  softcap at each width and the reduced config's shape
                  (``TF32_CASES``), and timed at granite-moe's,
                  internvl2's and zamba2's shapes and gemma3-1b's full and
                  window-512 layers at D = 256 beside SDPA in f32 on
                  efficient attention (``time_flash_f32``);
                  the flash cases at 8 seeds; K6 + K7 timed together beside
                  SDPA's backward; K5 at a query offset at phase 20's rank
                  shapes (gemma3-1b at m = 2 and 4, window 512 and none,
                  softcap, bf16 and f32; granite-moe, zamba2 at D = 80,
                  internvl2 at D = 128 and musicgen at m = 2, the last
                  three at m = 4 too; in f32 granite-moe and internvl2 at
                  m = 2 and zamba2 at m = 4), each rank
                  against its plain version and bitwise the rows of the
                  launch without an offset, and timed at the last rank
                  (the ``flash_fwd`` record's ``q_offset``).  Device times (torch.profiler; host time
                  and an L2 flush before each call left out) beside
                  the bound (bytes over 3.35 TB/s, or operations over the
                  type's peak; ``launch/roofline.py``), the plain version's time and, where one
                  PyTorch call computes the same function, that call's
                  time (never used by the port);
  4. small parity the port on the card against the same run on the CPU
                  (plain kernel versions): a small-CNN federation, and 3
                  rounds of federated LM training on gemma3-1b-smoke in f32;
  5. ResNet slice ``Federation`` at RESNET9_CIFAR100 width, 32x32 images,
                  100 classes, 20,000 samples, K = 100, participation 0.2,
                  batch 50, Dir(0.07), seed 0 — 3 rounds each of pfedsop and
                  fedavg with the launch counters reset just before, then 2
                  pfedsop rounds with the reference update held against the
                  kernel run;
  6. LM slice     ``train_lm_pfedsop`` at gemma3-1b full width and depth
                  (26 layers, N = 999,826,048 bf16): 4 clients, batch 2,
                  seq_len 2048, 2 local iterations, 3 rounds, eta 0.1, seed
                  0, with every launch counter reset just before and the
                  exact launch counts asserted; then one forward of the
                  trained model with ``kernel_impl="reference"`` held
                  against the kernel path on the same batch.
  7. methods     every method of the port (``METHODS`` plus pfedsop_nopc) at
                  the ResNet slice's width and data, 2 rounds each, with the
                  launch counters reset just before: per-method round times,
                  one K1/K2 pair per pfedsop round;
  8. sync/async   with cuDNN's deterministic algorithms from here on: the
                  degenerate async driver (always online, uniform speed,
                  buffer = concurrency = K') against the sync driver, 2
                  rounds of pfedsop and of fedavg, histories, broadcast and
                  client states bit for bit;
  9. async        the heterogeneous async run (lognormal speeds, sigma 1.0,
                  availability 0.3, buffer 4; ``examples/train_federated.py``'s
                  async example) of pfedsop, 6 versions, with the launch
                  counters reset just before: versions, sim_time, staleness,
                  micro-cohort sizes, and K1 = K2 = the dispatches it made;
                  the same run traced (obs level ``phase``) equal to it bit for
                  bit, with its phase times; the same run under
                  ``torch.profiler`` for the device's idle share;
 10. resume       the heterogeneous run checkpointed at version 4 (in-flight
                  work and a partly filled buffer on disk), restored into a
                  fresh driver and run on: the uninterrupted history bit for
                  bit;
 11. stores       pfedsop at the ResNet slice's width on a fleet of K = 1,000
                  clients (participation 0.02, so K' = 20; batch 50, T = 4,
                  seed 0, 3 rounds; client i holds the 50 images from
                  50 i mod 19,950), once on each store: device; host with
                  ``mmap_threshold_bytes=0``; mmap under ``build/chip_smoke``;
                  and the default host store (past its 4 GiB threshold, so
                  promoted to memmaps) with an 80-client LRU cache.  Each
                  history and every final client row (compared in client
                  ranges, as checkpoint shards stream them) bit for bit
                  against the device store's, K1 = K2 = 3 each; round times,
                  bytes moved each way, at-rest bytes and peak device memory
                  printed, and the cache's hit, miss and eviction counters.
                  Then phase 9's run on the host store: its history bit for
                  bit;
 12. serving      gemma3-1b at full width and depth (26 layers, bf16), batch
                  4, a 1,024-token random prompt (seed 0; longer than the 512
                  window, so the ring buffers wrap), 64 greedy decode steps,
                  capacity 1,088: ``prefill_with_caches`` then ``decode_step``
                  with every launch counter reset just before and the exact
                  K4/K5 counts asserted; the first decode step against a full
                  forward over prompt + token; the reference path
                  (``kernel_impl="reference"``) teacher-forced on the kernel
                  path's tokens, every step's logits within 2**-4 of the
                  largest; prefill ms, decode ms per step, tokens/s, peak
                  memory and the idle share over 16 profiled decode steps;
                  then ``python -m repro_torch.launch.serve --full --arch
                  gemma3-1b --batch 4 --steps 32`` once;
 13. arch train   phase 6's loop at full width and depth on granite-moe-1b-
                  a400m (MoE, 4 clients; K5-K7 and the sum pass at D = 64,
                  G = 2) and zamba2-2.7b (SSM + shared attention, 2 clients,
                  as many as its client state leaves room for; K5-K7 at D =
                  80): N, the bytes of client state, peak memory, the exact
                  launch counts; then on client 0's trained model the
                  reference path against the kernel path: per-token logits
                  within 2**-4 of the largest, the gradient within 4x the
                  sound runs' reading; over four client batches, each
                  token's NLL against an f32 run (the kernel path's median
                  error over the reference path's; on granite-moe K5's and
                  K4's outputs x1.01 planted and failing it), and the loss
                  gap (held where no token is routed to experts: zamba2);
 14. arch serve   zamba2-2.7b, internvl2-2b (256 random patch embeddings +
                  768 text tokens) and musicgen-large (4 codebooks, int8 KV
                  cache) at full width and depth, batch 4, a 1,024-position
                  prompt, 32 greedy steps: phase 12's checks (exact K4/K5
                  counts, the first step against a full forward, the
                  reference path within 2**-4) and its prefill ms, decode ms
                  per step, tokens/s and peak memory;
 15. launch       ``launch/dryrun.py``'s prediction for ``steps.make_train_step``
                  at phase 6's shape (one client, B = 2, S = 2048, T = 2),
                  counted on the meta device, then the step on the card at
                  full width and depth, for gemma3-1b and internvl2-2b
                  (``LAUNCH_ARCHS``; D = 128 and its 256 patch positions,
                  the batch from a seed in ``steps.token_batch``'s
                  layout): the launches equal the prediction's, the peak
                  device memory within 10 % of the predicted peak, the loss
                  within phase 13's limit of the reference path's; the
                  first local step's gradient per leaf against the
                  reference path and an f32 run of it (scale drift and
                  error ratio, ``grad_gaps``), and planted kernel faults
                  each failing that check (gemma3-1b 7, internvl2-2b the 4
                  of K5-K7 and the sum pass); then granite-moe-1b-a400m's
                  step at dtype float32 (in ``LAUNCH_ARCHS``: K6 and K7 on
                  the f32 tensor-core kernels at D = 64, G = 2, no sum
                  pass), its gradient per leaf against the f32 reference
                  path's (``f32_grad_gaps``) and the faults of K5, K6, K7
                  and K4 each failing it; the wall and device time and
                  the idle share of a profiled step, counted FLOPs against
                  ``model_flops``, the roofline terms and the new global
                  delta's gap printed.  Then K1/K2 at C = 1, N = 4 against
                  their plain versions, and ``scripts/torch_smoke_models.py``,
                  ``scripts/torch_smoke_fl.py`` and
                  ``examples/torch_quickstart.py`` on the card.
 16. mesh         a one-rank NCCL group (file store under
                  ``build/chip_smoke``) and the ``clients:1`` and
                  ``pods:1x1x1`` meshes; ``collectives.reduce_scatter``'s
                  NCCL branch bitwise the all-reduce then the slice
                  (``nccl_reduce_scatter_check``; phase 20's ranks take the
                  gloo branch); phase 5's ResNet slice, 3 rounds of
                  pfedsop and of fedavg, under ``shard_map`` (1 shard) and
                  ``mesh pods:1x1x1``, each with ``output_sharding``
                  replicated and sharded: histories, broadcast and client
                  rows bitwise the vmap run's, round times beside the vmap
                  ones, the collective census; before the group, the
                  model-sharded update emulated at m = 2, 4, 8 ranks (each rank's K1/K2 on its
                  tile range in turn, the zero-padded partials summed in
                  rank order) at C = 20, N = 1,249,956 f32 (shared and
                  per-client d_g), bf16 at a ragged N, and C = 1, N =
                  999,826,048: bitwise the whole-row pair and the whole-row
                  plain pair, each range's K2 bitwise its plain version and
                  its K1 within K1's limit, K1 = K2 = m launches a call
                  (rank 0's tile-range launches at m = 2 and 4 are timed in
                  phase 3, beside their bounds);
 17. mesh train   a one-rank NCCL group again: ``make_train_step`` at phase
                  15's shape through ``MeshBackend(1, pods:1x1x1)`` bit for
                  bit the engine-less step at ``grad_chunks`` 1 and 2 (exact
                  launches, peak device memory under 80 GB, at 2 chunks
                  beside the dry run's prediction); the 2-chunk step as a
                  data split over two processes on the card (gloo: NCCL
                  refuses two ranks on one device), each rank's result
                  bitwise (by digest) the in-body one; then
                  ``launch/train.py``'s round loop at gemma3-1b's full width,
                  3 rounds, replicated and sharded: equal losses.
 18. tp serve     gemma3-1b, granite-moe-1b-a400m (MoE, ``dense``),
                  zamba2-2.7b (SSM + shared attention, K5 at D = 80),
                  internvl2-2b (vision, whole ``embed``) and musicgen-large
                  (codebooks, int8 cache) at full width and depth in bf16,
                  each served tensor-parallel on ``pods:1x1x2`` by two
                  processes sharing the card (one spawn for all; gloo,
                  host-staged; NCCL refuses two ranks on one device): each
                  rank its model slices (``launch/sharding.py::
                  rank_plan``), phase 12's batch 4 and 1,024-position
                  prompt, then 16 decode steps teacher-forced on the whole
                  model's greedy tokens, the launch counters reset just
                  before (exact K4/K5 counts); each rank's last-token
                  logits and every step's against the whole-model run,
                  their worst |d| over 5e-3 + 5e-3 |want| at most the arch's
                  ``TP_LIMIT`` (1.34x the sound reading: at full depth in
                  bf16 a sound reordering of the sums reads 6.5-18, the
                  reference path's printed beside it), and each step's
                  vocab-parallel greedy tokens the first argmax of its
                  gathered logits; each rank's census of the prefill and
                  serve steps equal to the dry run's count of the same
                  shapes on a 2-rank fake world, and its peak within 10 %
                  of the dry run's; nine planted faults (``TP_FAULTS``: the
                  row-parallel all-reduce dropped, decode's owner write
                  skipped, its slot combine without the rescale, the
                  argmax's slice offset dropped, the MoE's f32 sum dropped,
                  the SSM's norm statistic rank-local, its conv gather in
                  the reverse rank order, the int8 write without its
                  scale, the codebook lookup without its offset) must each
                  read above their arch's limit or change a greedy token
                  of the sound run (each served until it does, at most its
                  steps); prefill ms, decode ms per step and the idle
                  share, with the card's name and power limit.  The whole
                  models' runs and the dry run's counts are made while the
                  two processes start, as are phase 19's counts and
                  one-process steps.
 19. tp train     the tensor-parallel train step (``make_train_step(tp=)``)
                  at phase 15's shape (one client, B = 2, S = 2048, T = 2,
                  bf16) on ``pods:1x1x2`` by two processes sharing the card
                  (one spawn; gloo, host-staged): gemma3-1b and
                  granite-moe-1b-a400m at full width and depth, zamba2-2.7b
                  at full width and one of its 9 repetitions (the full
                  depth would move ~40 GB a rank a step through gloo); each
                  rank its model slices, the step under the profiler with
                  the counters reset just before: census equal to rank 0's
                  step counted on meta in a 2-rank fake world, peak within
                  10 % of the count's, K1/K2/K4-K7 launches the count's,
                  the loss bitwise across the ranks and within 2e-5 of the
                  one-process step's, every replicated leaf of the outputs
                  bitwise across the ranks; the first local step's
                  gradient from the slices against the whole model's
                  (``grad_gaps`` per arch, ``TP_GRAD_LIMITS``) and six
                  planted faults (the attention input's ``enter`` dropped,
                  the head_dim K/V gather's backward a plain slice, the CE's
                  logsumexp over the local slice, the MoE gates' gradient
                  rank-local, the SSM norm statistic's backward and its
                  per-head leaves' gradient rank-local) outside those
                  limits; the round start's
                  (beta, eta1 coeff) from the slices within 1e-5 of the
                  whole tree's and the replicated leaves counted on every
                  rank outside it; step wall and idle share with the card's
                  name and power limit.
 20. seqshard     inside phase 18's two processes, after each arch's
                  serving: the sequence-parallel prefill (the dry run's
                  ``seqshard`` variant; ``make_prefill_step`` with
                  ``cfg.seq_shard``) of ``SEQ_CASES``: gemma3-1b,
                  granite-moe-1b-a400m (and its params at the
                  ``dispatch`` and ``dispatch_grouped`` impls at capacity
                  factor 0.5, dropping slots), zamba2-2.7b, internvl2-2b
                  and musicgen-large at full width and depth on phase
                  18's prompt, each rank its 512 positions with every
                  layer weight whole (``rank_plan(seqshard=True)``): its
                  census equal to the dry run's ``seqshard`` count of the
                  same shape on a 2-rank fake world (the SSM's halo and
                  state gathers and the dispatches' count gathers under
                  their own names), its peak within 3 % of the count's,
                  its K4/K5 launches the count's, its last-token logits
                  within ``SEQ_LIMIT`` of the whole model's (phase 18's
                  units), and eleven planted faults
                  (``scripts/seqshard_faults.py``, each read on its case:
                  RoPE on local positions, K/V not gathered, K5 at q0 =
                  0, the embedding's scatter in reversed rank order, the
                  last position from rank 0; the SSM state not carried,
                  the conv halo zeroed, the state fold in reverse rank
                  order; the patches on the wrong ranks; the codebook
                  partials of rank 0 only; the dispatch slot positions
                  left local) each above it; prefill ms and the idle
                  share beside phase 18's prefill.
                  Each phase prints its seconds, the TP ranks the seconds
                  of their parts, and ``time[...]`` lines the seconds
                  since the build began.

Prints a ``{"kernels": [...]}`` line (each flash record also holds its
D = 80 readings under ``d80`` (zamba2, H = KV = 32) and ``d80_rank``
(phase 19's rank, H = KV = 16), its D = 64 readings under ``d64``
(granite-moe's training shape), ``flash_fwd`` internvl2's prefill (D =
128, ``fwd_narrow_kernel<128>``) under ``d128_prefill``, K5-K7 and the sum
pass at internvl2's training shape (D = 128, the narrow kernels) under
``d128_train``, and K5's query-offset readings under ``q_offset``; the
window records a library time, SDPA with the window's mask; launches per
path under
``launches_by_path``; the f32 records ``flash_fwd_f32``,
``flash_bwd_dq_f32`` and ``flash_bwd_dkv_f32``, source ``flash_gqa.cu``,
granite-moe's training shape with internvl2's, zamba2's and gemma3-1b's
(D = 256) under ``f32_d128_train``, ``f32_d80`` and ``f32_d256``, launches
from every path that runs in
f32, counted under f32's own keys) and ends with
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path[:0] = [str(Path(__file__).resolve().parent / d) for d in ("src", "scripts")]

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100, SMALL_CNN  # noqa: E402
from repro_torch.core.baselines import FedAvg, PFedSOP  # noqa: E402
from repro_torch.core.pfedsop import PFedSOPConfig  # noqa: E402
from repro_torch.data import (  # noqa: E402
    FederatedData,
    dirichlet_partition,
    make_class_conditional_images,
)
from repro_torch.fl import (  # noqa: E402
    AsyncConfig,
    AsyncFederation,
    AvailabilityConfig,
    Federation,
    FLRunConfig,
    StoreConfig,
    masked_accuracy,
)
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.kernels.flash_gqa import ops as flash_ops  # noqa: E402
from repro_torch.kernels.pfedsop_update import ops  # noqa: E402
from repro_torch.kernels.pfedsop_update.ref import coeff_from_sums, gompertz_beta  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.launch import dryrun, profile_lm_step, profile_store, roofline  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.launch import train_lm_pfedsop as lm_driver  # noqa: E402
from repro_torch.launch.train_federated import METHOD_NAMES, build_method  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import ObsConfig, read_events  # noqa: E402
from repro_torch.utils.pytree import (  # noqa: E402
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

L2_FLUSH_BYTES = 256 * 2**20  # 5x the H100's 50 MB L2
MAIN_C, MAIN_N = 20, 1_249_956  # K' = 0.2 * 100 clients; RESNET9_CIFAR100 params
LM_N = 999_826_048  # gemma3-1b parameters (the LM path's C = 1 update)
SOURCE = "src/repro_torch/kernels/pfedsop_update/csrc/pfedsop_update.cu"
RMS_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
FLASH_SM90_SOURCE = "src/repro_torch/kernels/flash_gqa/csrc/flash_gqa_sm90.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_gqa/csrc/flash_gqa.cu"
LM = dict(clients=4, rounds=3, local_iters=2, batch=2, seq_len=2048)  # the LM slice
FLASH_SEEDS = (12, 21, 22, 23, 24, 25, 26, 27)  # check_flash: each case at each seed
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"  # gitignored
# examples/train_federated.py's async example: lognormal speeds, 30 % availability
HETERO = AsyncConfig(buffer_size=4, availability=AvailabilityConfig(
    speed="lognormal", sigma=1.0, availability=0.3))
ASYNC_VERSIONS = 6
STORE_K = 1000  # phase 11's fleet: K' = 0.02 K = 20, as the ResNet slice's
STORE_RANGE = 100  # clients per range of the final-row comparison
SERVE = dict(batch=4, prompt=1024, steps=64, capacity=1088, profiled=16)  # phase 12
SERVE_RTOL = 2.0 ** -4  # serving logits: kernel path against reference, in units of the largest


PROFILE_TRIES = 4  # device_ms: profiles taken before a short one fails the run
PROFILE_PAD_S = 0.02  # host idle at each end of a profile (see profiled)
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the markers that open a profile
MARKER_CYCLES = 1000  # each marker's spin, under a microsecond
PROFILE_MARKERS = {"launch": 64, "lost": 0}  # markers a profile opens with; most yet lost


def device_events(prof):
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


@functools.lru_cache(maxsize=None)
def l2_flush():
    """(buffer, names): an int32 buffer of ``L2_FLUSH_BYTES`` and the names
    of the kernels that ``buffer.bitwise_not_()`` launches.  That call reads
    and writes 5x the L2, so it leaves no operand of the call before it in
    the L2."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    buf.bitwise_not_()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        events = profiled(lambda: buf.bitwise_not_(), [torch.profiler.ProfilerActivity.CUDA])
        if len(events) == 1 and events[0].count == 1:
            return buf, frozenset(e.key for e in events)
        print(f"kernels[l2 flush]: the profile held {[(e.key, e.count) for e in events]} "
              "for one flush; profiling again", flush=True)
    raise AssertionError("the profiler did not see the L2 flush kernel once")


def profiled(body, acts):
    """The device events of one ``torch.profiler`` session around ``body()``
    and a synchronize, the session's markers left out.

    A session can lose its first device events: it holds the host's
    launches of them, not the kernels.  On an H100 (torch 2.11, CUDA 12.8),
    once another process had used the card, every session lost its first 2
    kernels, and 30 s later its first 4; where the first was
    ``device_ms``'s L2 flush, the profile held one flush too few.  So a
    session opens with markers (``torch.cuda._sleep``'s spin kernel) and a
    synchronize before ``body()`` launches anything.  Where a prefix of the
    session is lost, it is markers; where at least one marker is recorded,
    recording was on before ``body()`` began, and no event of it is lost at
    the start.  A session that records no marker is taken again, and each
    session opens with at least four times as many markers as any session
    lost so far (``PROFILE_MARKERS``).  The host also idles
    ``PROFILE_PAD_S`` at each end: the profiler drops device events that
    its clock places outside the session."""
    for _ in range(PROFILE_TRIES):
        launched = PROFILE_MARKERS["launch"]
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(launched):
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            body()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = device_events(prof)
        lost = launched - sum(e.count for e in events if MARKER in e.key)
        PROFILE_MARKERS["launch"] = max(launched, 4 * lost)
        if lost > PROFILE_MARKERS["lost"]:
            PROFILE_MARKERS["lost"] = lost
            print(f"kernels[profile]: a session lost its first {lost} of {launched} markers; "
                  f"sessions now open with {PROFILE_MARKERS['launch']}", flush=True)
        if lost < launched:
            return [e for e in events if MARKER not in e.key]
    raise AssertionError(f"no profile recorded one of its markers in {PROFILE_TRIES} tries "
                         f"({launched} the last)")


def device_ms(fn, calls=10, warmup=2):
    """Device time of one call of ``fn`` with its inputs in HBM: the device
    time of every kernel, copy and memset that ``calls`` calls launch
    (torch.profiler), summed and divided by ``calls``.  The L2 is flushed
    before each call (``l2_flush``; its kernel is left out by name), so an
    input under the 50 MB L2 is not read from the L2 of the call before, and
    the bytes bound over the HBM rate holds.  The host's share (the wrapper,
    the launch) and the gaps between launches are left out: CUDA events
    around a call would time the host too, which at tens of microseconds a
    call is most of the time of the fastest kernels here.

    The profile is complete only if it holds exactly ``calls`` flushes and
    every other kernel a multiple of ``calls`` times; ``profiled`` opens it
    with markers, so the events a session loses at its start are not the
    first flush and the first call's; a profile short all the same (the
    profiler lost or misplaced events) is taken again, up to
    ``PROFILE_TRIES`` times, and the run fails if none is complete.  ``fn``
    itself launching a flush kernel fails every try."""
    buf, flush = l2_flush()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def body():
        for _ in range(calls):
            buf.bitwise_not_()
            fn()

    for _ in range(PROFILE_TRIES):
        events = profiled(body, acts)
        flushes = sum(e.count for e in events if e.key in flush)
        ragged = sorted((e.key[:80], e.count) for e in events
                        if e.key not in flush and e.count % calls)
        us = sum(e.self_device_time_total for e in events if e.key not in flush)
        if flushes == calls * len(flush) and not ragged and us > 0:
            return us / 1e3 / calls
        print(f"kernels[device_ms]: incomplete profile ({flushes} flushes for {calls} calls, "
              f"counts not a multiple of {calls}: {ragged}, {us} us); profiling again",
              flush=True)
    raise AssertionError(f"no complete profile in {PROFILE_TRIES} tries: {flushes} flushes "
                         f"for {calls} calls, {ragged}, {us} us, flush {sorted(flush)}")


def reset_launches():
    for counts in (ops.LAUNCHES, rms_ops.LAUNCHES, flash_ops.LAUNCHES):
        for k in counts:
            counts[k] = 0


def all_launches():
    return {**ops.LAUNCHES, **rms_ops.LAUNCHES, **flash_ops.LAUNCHES}


def errors(got, want):
    """(max |got - want|, the same over max |want|: the error in units of
    the largest value), in f32.  An all-zero reference would make any
    comparison pass, so it fails here."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert scale > 0 and math.isfinite(scale), scale
    return err, err / scale


def make_operands(c, n, dtype, shared, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    dg = rnd(n) if shared else rnd(c, n)
    # local deltas partly aligned with the global one, so beta spans (0, 1)
    mix = torch.linspace(-1.0, 1.0, c, device="cuda")[:, None]
    di = 0.01 * (mix * dg + rnd(c, n))
    return (0.05 * rnd(c, n)).to(dtype), di.to(dtype), (0.01 * dg).to(dtype)


def check_kernels():
    """Each kernel against its plain version; returns the JSON records'
    measured fields (main-shape times, worst error over all cases)."""
    cases = [  # (label, C, N, dtype, shared d_g)
        ("main", MAIN_C, MAIN_N, torch.float32, True),
        ("per-client d_g", MAIN_C, MAIN_N, torch.float32, False),
        ("C=1 (K3)", 1, MAIN_N, torch.float32, True),
        ("ragged N", MAIN_C, 1_000_003, torch.float32, True),
        ("bf16", MAIN_C, MAIN_N, torch.bfloat16, True),
    ]
    worst = {"reduce3": 0.0, "update": 0.0}
    for i, (label, c, n, dtype, shared) in enumerate(cases):
        x, di, dg = make_operands(c, n, dtype, shared, seed=i)
        # K1: (C, T, 3) partials; sums of 4096 f32 products in another
        # order than torch.sum -> relative 1e-5 of the largest partial
        got = ops.reduce3_batched(di, dg)
        want = ops.reduce3_batched_plain(di, dg)
        err1 = (got - want).abs().max().item()
        tol1 = 1e-5 * want.abs().max().item()
        assert got.shape == (c, ops.n_tiles(n), 3) and err1 <= tol1, (label, err1, tol1)
        # K2 on the plain path's own beta/coefficient: the kernel rounds
        # each op as the plain version does -> equal up to 1 ulp of x
        dot, nl2, ng2 = want.sum(1).unbind(-1)
        beta = gompertz_beta(dot, nl2, ng2, 1.0).contiguous()
        ec = (0.01 * coeff_from_sums(dot, nl2, ng2, beta, 1.0)).contiguous()
        got2 = ops.update_batched(x, di, dg, beta, ec).float()
        want2 = ops.update_batched_plain(x, di, dg, beta, ec).float()
        err2 = (got2 - want2).abs().max().item()
        ulp = (2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7)
        tol2 = ulp * want2.abs().max().item()
        assert err2 <= tol2, (label, err2, tol2)
        # the pair end to end against the reference oracle
        xk, bk = ops.pfedsop_update_batched(x, di, dg, impl="kernel")
        xr, br = ops.pfedsop_update_batched(x, di, dg, impl="reference")
        torch.testing.assert_close(bk, br, rtol=1e-5, atol=1e-6)
        assert (xk.float() - xr.float()).abs().max().item() <= 2 * tol2 + 1e-7, label
        torch.cuda.synchronize()
        worst["reduce3"] = max(worst["reduce3"], err1)
        worst["update"] = max(worst["update"], err2)
        print(f"kernels[{label}]: C={c} N={n} {str(dtype)[6:]} shared={shared} "
              f"K1 max_abs_err={err1:.3g} (tol {tol1:.3g}) "
              f"K2 max_abs_err={err2:.3g} (tol {tol2:.3g}) beta={br.min().item():.3f}.."
              f"{br.max().item():.3f}", flush=True)

    x, di, dg = make_operands(MAIN_C, MAIN_N, torch.float32, True, seed=0)
    partials = ops.reduce3_batched(di, dg)
    dot, nl2, ng2 = partials.sum(1).unbind(-1)
    beta = gompertz_beta(dot, nl2, ng2, 1.0).contiguous()
    ec = (0.01 * coeff_from_sums(dot, nl2, ng2, beta, 1.0)).contiguous()
    b1, by1 = roofline.bound_ms(
        roofline.reduce3_cost(MAIN_C, MAIN_N, partials.shape[1], x.element_size()))
    b2, by2 = roofline.bound_ms(roofline.update_cost(MAIN_C, MAIN_N, x.element_size()))
    rec = {
        "reduce3": dict(
            ms=device_ms(lambda: ops.reduce3_batched(di, dg)),
            plain_ms=device_ms(lambda: ops.reduce3_batched_plain(di, dg)),
            bound_ms=b1, bound_by=by1),
        "update": dict(
            ms=device_ms(lambda: ops.update_batched(x, di, dg, beta, ec)),
            plain_ms=device_ms(lambda: ops.update_batched_plain(x, di, dg, beta, ec)),
            bound_ms=b2, bound_by=by2),
    }
    for k, r in rec.items():
        r["max_abs_err"] = worst[k]
        print(f"kernels[time {k}]: C={MAIN_C} N={MAIN_N} f32 kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), kernel at {100 * r['bound_ms'] / r['ms']:.1f}% "
              "of bound", flush=True)
    return rec


def check_update_c1():
    """K1/K2 at the LM path's C = 1, N = 999,826,048 f32 (the flattened
    gemma3-1b tree): each against its plain version, then timed.  Returns
    the C = 1 numbers the update records carry besides their main ones."""
    x, di, dg = make_operands(1, LM_N, torch.float32, True, seed=7)
    got = ops.reduce3_batched(di, dg)
    want = ops.reduce3_batched_plain(di, dg)
    err1 = (got - want).abs().max().item()
    assert err1 <= 1e-5 * want.abs().max().item(), err1
    dot, nl2, ng2 = want.sum(1).unbind(-1)
    beta = gompertz_beta(dot, nl2, ng2, 1.0).contiguous()
    ec = (0.1 * coeff_from_sums(dot, nl2, ng2, beta, 1.0)).contiguous()
    out = ops.update_batched(x, di, dg, beta, ec)
    ref = ops.update_batched_plain(x, di, dg, beta, ec)
    err2 = (out - ref).abs().max().item()
    assert err2 <= 2.0 ** -23 * ref.abs().max().item(), err2
    del got, want, out, ref
    torch.cuda.empty_cache()
    b1, _ = roofline.bound_ms(
        roofline.reduce3_cost(1, LM_N, ops.n_tiles(LM_N), x.element_size()))
    b2, _ = roofline.bound_ms(roofline.update_cost(1, LM_N, x.element_size()))
    rec = {
        "reduce3": dict(c1_ms=device_ms(lambda: ops.reduce3_batched(di, dg), calls=10),
                        c1_plain_ms=device_ms(lambda: ops.reduce3_batched_plain(di, dg),
                                              calls=5, warmup=1),
                        c1_bound_ms=b1, c1_max_abs_err=err1),
        "update": dict(c1_ms=device_ms(lambda: ops.update_batched(x, di, dg, beta, ec), calls=10),
                       c1_plain_ms=device_ms(
                           lambda: ops.update_batched_plain(x, di, dg, beta, ec),
                           calls=5, warmup=1),
                       c1_bound_ms=b2, c1_max_abs_err=err2),
    }
    for k, r in rec.items():
        print(f"kernels[time {k} C=1]: N={LM_N} f32 kernel {r['c1_ms']:.4f} ms, plain "
              f"{r['c1_plain_ms']:.4f} ms, bound {r['c1_bound_ms']:.4f} ms (bytes), kernel "
              f"at {100 * r['c1_bound_ms'] / r['c1_ms']:.1f}% of bound, max_abs_err "
              f"{r['c1_max_abs_err']:.3g}", flush=True)
    del x, di, dg
    torch.cuda.empty_cache()
    return rec


def _randn(g, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)


def check_rmsnorm():
    """K4 against its plain version at the LM slice's shapes (ln1/ln2/final
    (4096, 1152), q-norm (16384, 256), k-norm (4096, 256)) and a ragged row
    count, f32 and bf16.  Tolerance in units of the largest output: f32
    1e-5 (a 1,152-term f32 sum in another order), bf16 2**-7 (one ulp: a
    value next to a rounding boundary may round the other way)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for rows, d in ((4096, 1152), (16384, 256), (4096, 256), (1001, 1152)):
        for dtype in (torch.bfloat16, torch.float32):
            x = _randn(g, rows, d, dtype=dtype, scale=3.0)
            sc = _randn(g, d, dtype=dtype, scale=0.5)
            err, rel = errors(rms_ops.rmsnorm_fwd(x, sc), rms_ops.rmsnorm_plain(x, sc))
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            assert rel <= tol, (rows, d, dtype, rel)
            worst = max(worst, err)
            print(f"kernels[rmsnorm ({rows}, {d}) {str(dtype)[6:]}]: max_abs_err {err:.3g}, "
                  f"relative {rel:.3g} (tol {tol:.3g})", flush=True)
    x = _randn(g, 4096, 1152, dtype=torch.bfloat16, scale=3.0)
    sc = _randn(g, 1152, dtype=torch.bfloat16, scale=0.5)
    lib = None
    if hasattr(F, "rms_norm"):  # PyTorch >= 2.4
        w = (1.0 + sc.float()).to(sc.dtype)
        lib = device_ms(lambda: F.rms_norm(x, (1152,), weight=w, eps=1e-6))
        # the same function: (1 + scale) rounded to bf16 and bf16 roundings
        # at other places leave a few ulps
        torch.testing.assert_close(F.rms_norm(x, (1152,), weight=w, eps=1e-6),
                                   rms_ops.rmsnorm_fwd(x, sc), rtol=2.0 ** -5,
                                   atol=2.0 ** -5)
    b, by = roofline.bound_ms(roofline.rmsnorm_cost(*x.shape, x.element_size()))
    rec = dict(ms=device_ms(lambda: rms_ops.rmsnorm_fwd(x, sc)),
               plain_ms=device_ms(lambda: rms_ops.rmsnorm_plain(x, sc)),
               bound_ms=b, bound_by=by, library_ms=lib, max_abs_err=worst)
    _print_time("rmsnorm (4096, 1152) bf16", rec)
    return rec


def _print_time(label, r):
    lib = "none" if r.get("library_ms") is None else f"{r['library_ms']:.4f} ms"
    print(f"kernels[time {label}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel at "
          f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound", flush=True)


def _attention(g, h, kv, dtype, b=2, s=2048, d=256):
    q = _randn(g, b, s, h, d, dtype=dtype)
    k = _randn(g, b, s, kv, d, dtype=dtype)
    v = _randn(g, b, s, kv, d, dtype=dtype)
    do = _randn(g, b, s, h, d, dtype=dtype)
    return q, k, v, do


bf16, f32 = torch.bfloat16, torch.float32
FLASH_CASES = [  # (G, window, softcap, dtype, S, D, H, B)
    (4, 512, None, bf16, 2048, 256, 4, 2), (4, None, None, bf16, 2048, 256, 4, 2),
    (1, 512, 50.0, bf16, 2048, 256, 4, 2), (4, None, 50.0, f32, 2048, 256, 4, 2),
    (1, 512, None, f32, 2048, 256, 4, 2),
    (4, 512, None, bf16, 2048, 64, 4, 2), (4, None, None, bf16, 2048, 64, 4, 2),
    (4, 512, None, bf16, 2048, 128, 4, 2), (4, None, None, bf16, 2048, 128, 4, 2),
    (4, 512, None, bf16, 1000, 256, 4, 2), (4, 16, None, bf16, 40, 64, 4, 2),
    (1, None, None, bf16, 2048, 80, 32, 2), (1, None, None, f32, 2048, 80, 32, 2),
    (2, 512, 50.0, bf16, 1000, 80, 4, 2),
    (2, None, None, bf16, 2048, 64, 16, 2),   # granite-moe-1b-a400m, phase 13
    (2, None, None, bf16, 1024, 128, 16, 4),  # internvl2-2b prefill, phase 14
    (2, None, None, bf16, 2048, 128, 16, 2),  # internvl2-2b training, phase 15
    (1, None, None, bf16, 1024, 64, 32, 4),   # musicgen-large prefill, phase 14
    # phase 18: one tensor-parallel rank of gemma3-1b at m = 2 (its 2 query
    # heads over the gathered KV head), full and window-512 layers
    (2, None, None, bf16, 1024, 256, 2, 4), (2, 512, None, bf16, 1024, 256, 2, 4),
    # phase 18: a rank at m = 2 of granite-moe-1b-a400m (8 over 4),
    # zamba2-2.7b (16 over 16, D = 80), internvl2-2b (8 over 4), musicgen-large
    (2, None, None, bf16, 1024, 64, 8, 4), (1, None, None, bf16, 1024, 80, 16, 4),
    (2, None, None, bf16, 1024, 128, 8, 4), (1, None, None, bf16, 1024, 64, 16, 4),
    # phase 19: a training rank at m = 2 (B = 2, S = 2048) of gemma3-1b (2
    # over the gathered KV head, full and window-512 layers), granite-moe
    # (8 over 4) and zamba2 (16 over 16, D = 80)
    (2, None, None, bf16, 2048, 256, 2, 2), (2, 512, None, bf16, 2048, 256, 2, 2),
    (2, None, None, bf16, 2048, 64, 8, 2), (1, None, None, bf16, 2048, 80, 16, 2),
    # the D = 80 kernels' edges: S = 40, window 16 (shorter than one tile);
    # S = 1,100 (K7's last 128-key block: the second warpgroup's keys partly
    # past S) and 1,040 (wholly past S, G = 2, softcap); S = 2,048, window 512
    (2, 16, None, bf16, 40, 80, 4, 2), (1, None, None, bf16, 1100, 80, 32, 2),
    (2, 512, 50.0, bf16, 1040, 80, 4, 2), (1, 512, None, bf16, 2048, 80, 32, 2),
    # the same edges at D = 64, where K5-K7 run the same narrow kernels
    # (128-key K5 and K6 tiles, 128-key K7 blocks): S = 1,100 (a partial last
    # tile; K7's last block's second warpgroup partly past S), 1,040 (G = 2,
    # window 512, softcap 50), S = 2,048 at window 512
    (1, None, None, bf16, 1100, 64, 32, 2), (2, 512, 50.0, bf16, 1040, 64, 4, 2),
    (1, 512, None, bf16, 2048, 64, 32, 2),
    # the same edges at D = 128, where K5-K7 run the narrow kernels too (K6
    # on a 2-stage ring): S = 40 at window 16 (G = 2), S = 1,100 (a partial
    # last tile; K7's last block's second warpgroup partly past S), 1,040 (G
    # = 2, window 512, softcap 50), S = 2,048 at window 512
    (2, 16, None, bf16, 40, 128, 4, 2), (1, None, None, bf16, 1100, 128, 32, 2),
    (2, 512, 50.0, bf16, 1040, 128, 4, 2), (1, 512, None, bf16, 2048, 128, 32, 2),
    # f32 at D = 64, 80 and 128, where K6 and K7 run on the tensor cores
    # (dq_ and dkv_wgmma_kernel at 64; dq_ and dkv_tf32_kernel at 80 and 128;
    # zamba2's D = 80, H = KV = 32, is above): granite-moe's and internvl2's
    # training shapes (phase 15 runs granite-moe's step in f32); a ragged S
    # with window and softcap at each width (S = 1,040: the last 64-row
    # block and 32-row tile partial at 64, K6's last 64-key tile at 80 and
    # 128; 1,100: K7's last 128-key block's last warps past S; 40: shorter
    # than one tile); the reduced config's own shape (B =
    # 4, S = 64, H 4 over KV 1, D = 64, window 512), every LM entry point's
    # default
    (2, None, None, f32, 2048, 64, 16, 2), (2, None, None, f32, 2048, 128, 16, 2),
    (2, 512, 50.0, f32, 1040, 64, 4, 2), (1, 512, 50.0, f32, 1100, 80, 4, 2),
    (2, 16, 50.0, f32, 40, 128, 4, 2), (2, 512, 50.0, f32, 1100, 128, 4, 2),
    (4, 512, None, f32, 64, 64, 4, 4)]
# the bf16 cases at D = 64, 80 and 128, where K5, K6 and K7 run
# fwd_narrow_kernel, dq_narrow_kernel and dkv_narrow_kernel
NARROW_CASES = [c for c in FLASH_CASES if c[5] in (64, 80, 128) and c[3] == bf16]
# the f32 cases at D = 64, 80 and 128, where K5, K6 and K7 run their
# products on the tensor cores, three TF32 products each
TF32_CASES = [c for c in FLASH_CASES if c[5] in (64, 80, 128) and c[3] == f32]
# K6's and K7's limit there, in units of the largest value: under f32's 1e-4,
# between the sound kernels' worst reading (6.7e-6, dk and dv; PERF.md,
# Findings) and what a lost term of the split or a long sum left to
# the tensor cores' own accumulation reads (1.3e-5 and more)
TF32_BWD_TOL = 1e-5
# K5's limit there, in units of the largest value: under f32's 1e-4,
# between the sound kernel's worst reading over 8 seeds (1.6e-6; 4.4e-6 on
# the offset ranks, whose largest value is smaller; PERF.md, Findings) and
# the one-TF32-product control's (3.9e-4, its LSE 9.2e-5)
TF32_FWD_TOL = 1e-5


def check_flash(seeds=FLASH_SEEDS, cases=FLASH_CASES):
    """K5-K7 against their plain versions, once for each seed: at the LM
    slice's attention shapes (B = 2, S = 2048, D = 256; gemma3-1b's H = 4
    over KV = 1, i.e. G = 4, and G = 1), window 512 and none, softcap 50 and
    none, bf16 and f32; in bf16 also at D = 64 and 128 (G = 4, window 512 and
    none), at a ragged S = 1,000 (D = 256, window 512), where the last tiles
    are partial, and at S = 40 (D = 64, window 16), shorter than one tile;
    and at zamba2's shared attention, D = 80 (H = KV = 32, no window, bf16
    and f32; K5, K6 and K7 run kernels of their own on 80-column tiles),
    plus a masked D = 80 case (G = 2, window 512, softcap 50, ragged S =
    1,000) and the D = 80 kernels' edges: S = 40 at window 16 (shorter than
    one tile), S = 1,100 (the last 128-key K7 block's second warpgroup partly
    past S; K5's last 128-key tile partial), S = 1,040 (wholly past S; G = 2,
    window 512, softcap 50) and S = 2,048 at window 512; and the same three
    edges at D = 64, where K5, K6 and K7 run the same narrow kernels, and
    all four at D = 128, where they run them too.
    Phases 13 to 15's own shapes, bf16, no window: granite-moe's training
    (B = 2, S = 2048, H = 16 over KV = 8, D = 64: G = 2 and its sum pass),
    internvl2's prefill (B = 4, S = 1024, H = 16 over KV = 8, D = 128) and
    training (B = 2, S = 2048) and
    musicgen's (B = 4, S = 1024, H = KV = 32, D = 64); phase 18's
    tensor-parallel rank of gemma3-1b at m = 2 (B = 4, S = 1024, H = 2
    over KV = 1, D = 256, window 512 and none), and its ranks at m = 2 of
    granite-moe-1b-a400m (H = 8 over KV = 4, D = 64), zamba2-2.7b (16 over
    16, D = 80), internvl2-2b (8 over 4, D = 128) and musicgen-large (16
    over 16, D = 64), each B = 4, S = 1024, no window; phase 19's training
    ranks at m = 2 (B = 2, S = 2048): gemma3-1b's 2 over 1 (D = 256, window
    512 and none), granite-moe's 8 over 4 (D = 64) and zamba2's 16 over 16
    (D = 80), no window.
    The backward kernels take the plain forward's LSE and delta, so each is
    checked alone.  Tolerance in units of the largest value: f32 1e-4 (sums
    of up to 8,192 f32 terms in another order, the online softmax against
    one logsumexp), bf16 2**-7 (one ulp of the output); the LSE is f32 in
    both and held to 1e-5.  At f32's tensor-core widths (D = 64, 80, 128:
    three TF32 products a product) K5 is held to ``TF32_FWD_TOL`` and K6
    and K7 to ``TF32_BWD_TOL``, 1e-5 each, which a lost term of the split
    fails.

    In bf16, K5 rounds P to bf16 before the PV product (where the model's
    reference rounds it; the plain version keeps f32), K6 rounds dS to bf16
    before the dS K product and K7 rounds P^T and dS^T to bf16 before the
    dV and dK products (the TPU kernels keep f32); all multiply bf16 tiles
    on the tensor cores with f32 sums.  A bf16 output that rounds the other
    way at the largest value's binade reads up to one ulp there, the whole
    tolerance, however small the error before rounding.  So K6's f32 dq
    before its final rounding (every bf16 case) and, at G > 1, K7's f32 head
    partials before its sum pass rounds them, are held to the plain version
    on the inputs widened to f32 within 2**-8 of the largest value: half an
    ulp, under which the rounded outputs cannot leave the 2**-7 tolerance.
    (In f32, without a softcap, the SIMT dq and dk/dv passes may equal their
    plain versions bit for bit: both accumulate each sum as one FMA chain
    in the same order, as cuBLAS's f32 GEMM does.)  K6's dq and K7's dk and
    dv must be bitwise the same over two launches; K7's sum pass (G > 1 in
    bf16) must equal its plain version bit for bit (the same f32 adds in
    head order).  Returns the worst absolute error of each kernel over all
    cases and seeds, and under ``<name>_f32`` over the f32 cases at D = 64, 80
    and 128 (``TF32_CASES``)."""
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "flash_bwd_dkv_sum": 0.0, "flash_fwd_f32": 0.0, "flash_bwd_dq_f32": 0.0,
             "flash_bwd_dkv_f32": 0.0}
    worst_rel = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    worst_pre = {"dq": 0.0, "dk/dv": 0.0}  # before the final rounding, bf16
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        for gq, window, cap, dtype, s, d, h, b in cases:
            q, k, v, do = _attention(g, h, h // gq, dtype, b=b, s=s, d=d)
            kw = dict(window=window, softcap=cap)
            out, lse = flash_ops.flash_fwd(q, k, v, **kw)
            pout, plse = flash_ops.flash_fwd_plain(q, k, v, **kw)
            delta = flash_ops.row_delta(do, pout)
            lse_err = errors(lse, plse)
            dq = flash_ops.flash_bwd_dq(q, k, v, do, plse, delta, **kw)
            dq2 = flash_ops.flash_bwd_dq(q, k, v, do, plse, delta, **kw)
            dk, dv = flash_ops.flash_bwd_dkv(q, k, v, do, plse, delta, **kw)
            dk2, dv2 = flash_ops.flash_bwd_dkv(q, k, v, do, plse, delta, **kw)
            pdk, pdv = flash_ops.flash_bwd_dkv_plain(q, k, v, do, plse, delta, **kw)
            pairs = {"flash_fwd": [errors(out, pout)],
                     "flash_bwd_dq": [errors(dq, flash_ops.flash_bwd_dq_plain(
                         q, k, v, do, plse, delta, **kw))],
                     "flash_bwd_dkv": [errors(dk, pdk), errors(dv, pdv)]}
            torch.cuda.synchronize()
            label = (f"seed={seed} B={b} H={h} G={gq} window={window} softcap={cap} "
                     f"{str(dtype)[6:]} S={s} D={d}")
            assert torch.equal(dq, dq2), ("K6 not deterministic", label)
            assert torch.equal(dk, dk2) and torch.equal(dv, dv2), ("K7 not deterministic", label)
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            tc = dtype == f32 and d in flash_ops.TF32_HEAD_DIMS  # K5-K7 on the tensor cores
            line = []
            for name, es in pairs.items():
                limit = tol if not tc else TF32_FWD_TOL if name == "flash_fwd" else TF32_BWD_TOL
                for err, rel in es:
                    assert rel <= limit, (name, label, err, rel, limit, "lse", lse_err)
                    worst[name] = max(worst[name], err)
                    if tc:
                        worst[name + "_f32"] = max(worst[name + "_f32"], err)
                    if dtype == bf16:
                        worst_rel[name] = max(worst_rel[name], rel)
                    line.append(f"{name[6:]} {err:.3g}/{rel:.3g}")
            assert lse_err[1] <= 1e-5, (label, lse_err)
            worst["flash_fwd"] = max(worst["flash_fwd"], lse_err[0])
            if tc:
                worst["flash_fwd_f32"] = max(worst["flash_fwd_f32"], lse_err[0])
            if dtype == bf16:
                # K6's dq, and K7's dk/dv at G > 1, in f32 before their final
                # rounding, against the plain versions on widened inputs
                wide = [t.float() for t in (q, k, v, do)]
                pre = {"dq": errors(
                    flash_ops.flash_bwd_dq_wide(q, k, v, do, plse, delta, **kw),
                    flash_ops.flash_bwd_dq_plain(*wide, plse, delta, **kw))[1]}
                if gq > 1:
                    pk, pv = flash_ops.flash_bwd_dkv_partials(q, k, v, do, plse, delta, **kw)
                    refs = flash_ops.flash_bwd_dkv_plain(*wide, plse, delta, **kw)
                    pre["dk/dv"] = max(errors(p.reshape(*k.shape[:3], gq, d).sum(3), r)[1]
                                       for p, r in zip((pk, pv), refs))
                for name, rel in pre.items():
                    assert rel <= 2.0 ** -8, (f"{name} before rounding", label, rel)
                    worst_pre[name] = max(worst_pre[name], rel)
                    line.append(f"{name} before rounding -/{rel:.3g} (tol {2.0 ** -8:.3g})")
            tols = f"K5 {TF32_FWD_TOL:.3g}, dq and dk/dv {TF32_BWD_TOL:.3g}" if tc else f"{tol:.3g}"
            print(f"kernels[flash {label}]: max_abs_err/relative " + ", ".join(line) +
                  f", lse {lse_err[0]:.3g}/{lse_err[1]:.3g} (tol {tols}, lse 1e-05); "
                  "dq, dk/dv bitwise over two launches", flush=True)
    print(f"kernels[flash bf16, worst of {len(seeds)} seeds]: relative " + ", ".join(
        f"{n[6:]} {r:.6g} ({100 * r / 2.0 ** -7:.1f}% of tol)" for n, r in worst_rel.items())
        + "; before rounding " + ", ".join(
            f"K{6 if n == 'dq' else 7} {r:.6g} ({100 * r / 2.0 ** -8:.1f}% of 2**-8)"
            for n, r in worst_pre.items()), flush=True)

    # K7's sum pass at the LM slice's and granite-moe's shapes: f32 partials
    # (B, S, H, D) -> bf16 (B, S, KV, D)
    for shape, kv in (((2, 2048, 4, 256), 1), ((2, 2048, 16, 64), 8),
                      ((2, 2048, 2, 256), 1), ((2, 2048, 8, 64), 4)):  # phase 19's ranks
        pk, pv = (_randn(g, *shape) for _ in range(2))
        got = flash_ops.flash_bwd_dkv_sum(pk, pv, kv)
        want = flash_ops.flash_bwd_dkv_sum_plain(pk, pv, kv)
        for a, b in zip(got, want):
            assert torch.equal(a, b), ("sum pass differs from its plain version", shape, kv)
            worst["flash_bwd_dkv_sum"] = max(worst["flash_bwd_dkv_sum"],
                                             (a.float() - b.float()).abs().max().item())
        print(f"kernels[flash dk/dv sum pass {shape} KV={kv} f32 -> bf16]: bitwise equal to "
              "its plain version", flush=True)
    return worst


def time_flash(h, kv, d, windows, seed, b=2, s=2048, fwd_only=False, dtype=bf16):
    """Times at one attention shape in ``dtype`` (bf16 unless given; B = 2,
    S = 2,048 unless given):
    the records at a full-attention layer, where one PyTorch call,
    ``F.scaled_dot_product_attention``, computes the same function, each
    further window of ``windows`` printed beside them as ``window<w>``, its
    yardstick SDPA with the window's boolean mask (K/V heads repeated to H
    for it); K6 + K7 timed as one backward beside SDPA's; at G > 1 in bf16
    also K7's sum pass alone.  ``fwd_only``: K5 and SDPA's forward alone (a
    prefill's shape).  In f32 the yardstick is SDPA in f32 on its
    efficient-attention backend (``_sdpa``), the fused one that takes f32.
    Bounds count the visible (query, key) pairs: 4D flops each
    forward, 6D for the dq pass (scores, dO v^T, dq), 8D for the dk/dv pass,
    at the type's rate (``roofline.flash_peak``: bf16's peak, or a third of
    TF32's in f32), over the D columns; every kernel's tiles hold the true
    D (at D = 80 a 64- and a 16-column block), so the work past the count is
    the masked pairs of the tiles on the diagonal and the window's edge."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = _attention(g, h, kv, dtype, b=b, s=s, d=d)
    name_t = str(dtype)[6:]
    recs = {}
    for window in windows:
        out, lse = flash_ops.flash_fwd(q, k, v, window=window)
        delta = flash_ops.row_delta(do, out)
        shape = (b, s, h, kv, d, window, q.element_size())
        fns = {
            "flash_fwd": (lambda: flash_ops.flash_fwd(q, k, v, window=window),
                          lambda: flash_ops.flash_fwd_plain(q, k, v, window=window),
                          roofline.flash_fwd_cost(*shape)),
            "flash_bwd_dq": (
                lambda: flash_ops.flash_bwd_dq(q, k, v, do, lse, delta, window=window),
                lambda: flash_ops.flash_bwd_dq_plain(q, k, v, do, lse, delta, window=window),
                roofline.flash_dq_cost(*shape)),
            "flash_bwd_dkv": (
                lambda: flash_ops.flash_bwd_dkv(q, k, v, do, lse, delta, window=window),
                lambda: flash_ops.flash_bwd_dkv_plain(q, k, v, do, lse, delta, window=window),
                roofline.flash_dkv_cost(*shape)),
        }
        for name, (kern, plain, cost) in fns.items():
            if fwd_only and name != "flash_fwd":
                continue
            bnd, by = roofline.bound_ms(cost)
            # K7's time includes its sum pass over the f32 head partials
            r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, calls=5, warmup=1),
                     bound_ms=bnd, bound_by=by)
            _print_time(f"{name} window={window} B={b} S={s} H={h} KV={kv} D={d} {name_t}", r)
            if window is None:
                recs[name] = r
            else:
                recs[name][f"window{window}"] = r

    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa, kt, vt, backend = _sdpa(kt, vt, h, dtype)
    want, lse = flash_ops.flash_fwd(q, k, v)
    torch.testing.assert_close(sdpa(qt, kt, vt).transpose(1, 2), want, rtol=2.0 ** -6,
                               atol=2.0 ** -6)
    recs["flash_fwd"]["library_ms"] = device_ms(lambda: sdpa(qt, kt, vt))
    recs["flash_fwd"]["library"] = backend
    for window in windows:  # SDPA with each window's boolean mask
        if window is not None:
            _time_sdpa_window(recs, window, flash_ops.flash_fwd(q, k, v, window=window)[0],
                              qt, kt, vt, dot, fwd_only)
    if fwd_only:
        print(f"kernels[time sdpa full-attention D={d} {name_t}, {backend}]: forward "
              f"{recs['flash_fwd']['library_ms']:.4f} ms", flush=True)
        return recs
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    o = sdpa(*leaves)
    bwd = device_ms(lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True))
    # one call computes dq, dk and dv: the yardstick of both passes together
    recs["flash_bwd_dq"]["library_ms"] = recs["flash_bwd_dkv"]["library_ms"] = bwd
    print(f"kernels[time sdpa full-attention D={d} {name_t}, {backend}]: forward "
          f"{recs['flash_fwd']['library_ms']:.4f} ms, backward (dq, dk, dv) {bwd:.4f} ms",
          flush=True)
    delta = flash_ops.row_delta(do, want)
    pair = device_ms(lambda: (flash_ops.flash_bwd_dq(q, k, v, do, lse, delta),
                              flash_ops.flash_bwd_dkv(q, k, v, do, lse, delta)))
    recs["flash_bwd_dq"]["with_dkv_ms"] = pair
    print(f"kernels[time K6 + K7 full-attention D={d} {name_t}]: {pair:.4f} ms, SDPA's "
          f"backward {bwd:.4f} ms ({pair / bwd:.2f}x)", flush=True)
    if h == kv or dtype != bf16:
        return recs

    # K7's sum pass alone: reads G f32 partials of dk and of dv, writes both
    pk, pv = (torch.empty((b, s, h, d), device="cuda") for _ in range(2))
    pk.normal_(generator=g)
    pv.normal_(generator=g)
    outs = flash_ops.flash_bwd_dkv_sum(pk, pv, kv)
    bnd, by = roofline.bound_ms(roofline.flash_dkv_sum_cost(b, s, h, kv, d))
    recs["flash_bwd_dkv_sum"] = dict(
        ms=device_ms(lambda: flash_ops.flash_bwd_dkv_sum(pk, pv, kv)),
        plain_ms=device_ms(lambda: flash_ops.flash_bwd_dkv_sum_plain(pk, pv, kv)),
        bound_ms=bnd, bound_by=by, library_ms=None)
    _print_time(f"flash_bwd_dkv_sum B={b} S={s} H={h} KV={kv} D={d} f32 -> bf16",
                recs["flash_bwd_dkv_sum"])
    return recs


def _sdpa(kt, vt, h, dtype):
    """(SDPA as ``time_flash`` calls it, kt and vt as it takes them, the name
    of its backend) on (B, heads, S, D) operands.  bf16: SDPA's own choice,
    with ``enable_gqa`` from PyTorch 2.5 on (before it, the KV heads
    repeated to H).  f32: the efficient-attention backend, the fused one
    that takes f32 (the flash backend does not), on K/V heads repeated to H;
    a refusal raises."""
    if dtype == bf16 and tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5):
        return (lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True, enable_gqa=True)), kt, vt, "SDPA default, enable_gqa"
    kt, vt = (t.repeat_interleave(h // t.shape[1], dim=1) for t in (kt, vt))
    if dtype == bf16:
        return (lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True)), \
            kt, vt, "SDPA default, KV repeated"
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa(a, b_, c):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(a, b_, c, is_causal=True)
    return sdpa, kt, vt, "SDPA efficient attention, KV repeated"


def time_flash_other_shapes():
    """Phase 3's times beyond the LM slice's gemma3-1b, each a ``time_flash``
    record set under its key: zamba2's shared attention (``d80``: H = KV =
    32, D = 80), phase 19's zamba2 training rank at m = 2 (``d80_rank``: H =
    KV = 16), granite-moe's training shape (``d64``: phase 13, H = 16 over
    KV = 8, D = 64, with K7's sum pass), internvl2's prefill
    (``d128_prefill``: phase 14, B = 4, S = 1,024, H = 16 over KV = 8, D =
    128; K5 alone) and its training shape (``d128_train``: phase 15, B = 2,
    S = 2,048; K5-K7 and the sum pass)."""
    return {"d80": time_flash(32, 32, 80, (None,), seed=14),
            "d80_rank": time_flash(16, 16, 80, (None,), seed=15),
            "d64": time_flash(16, 8, 64, (None,), seed=16),
            "d128_prefill": time_flash(16, 8, 128, (None,), seed=17, b=4, s=1024,
                                       fwd_only=True),
            "d128_train": time_flash(16, 8, 128, (None,), seed=18)}


# phase 3's f32 times (K5-K7 of flash_gqa.cu), each a ``time_flash`` record
# set: (key, H, KV, D, seed, windows); B = 2, S = 2,048: granite-moe's
# training shape, internvl2's and zamba2's shared attention, no window
# (the tensor-core kernels), and gemma3-1b's full and window-512 layers at
# D = 256 (the SIMT kernels)
F32_TIMES = (("f32_d64", 16, 8, 64, 16, (None,)), ("f32_d128_train", 16, 8, 128, 18, (None,)),
             ("f32_d80", 32, 32, 80, 14, (None,)),
             ("f32_d256", 4, 1, 256, 13, (None, 512)))


def time_flash_f32():
    """Phase 3's f32 times: ``time_flash`` in f32 at each shape of
    ``F32_TIMES``, beside SDPA in f32 (efficient attention; with the
    window's boolean mask at window 512)."""
    return {key: time_flash(h, kv, d, windows, seed=seed, dtype=f32)
            for key, h, kv, d, seed, windows in F32_TIMES}


def _time_sdpa_window(recs, window, want, qt, kt, vt, dot, fwd_only):
    """SDPA with the window's boolean mask, the yardstick of ``recs``'s
    ``window<w>`` records: its forward (held to K5's output ``want``) and,
    unless ``fwd_only``, its backward, the yardstick of K6 and K7 together.
    qt, kt, vt, dot: (B, heads, S, D); K/V heads are repeated to H here
    (SDPA's ``enable_gqa`` does not take a mask on every version)."""
    h, s = qt.shape[1], qt.shape[2]
    kt, vt = (x.repeat_interleave(h // x.shape[1], dim=1) for x in (kt, vt))
    mask = flash_ops.visible_mask(s, window, "cuda")
    sdpa = lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=mask)  # noqa: E731
    torch.testing.assert_close(sdpa(qt, kt, vt).transpose(1, 2), want, rtol=2.0 ** -6,
                               atol=2.0 ** -6)
    rec = {n: r[f"window{window}"] for n, r in recs.items() if f"window{window}" in r}
    rec["flash_fwd"]["library_ms"] = device_ms(lambda: sdpa(qt, kt, vt))
    name_t = str(qt.dtype)[6:]
    line = f"forward {rec['flash_fwd']['library_ms']:.4f} ms"
    if not fwd_only:
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        o = sdpa(*leaves)
        bwd = device_ms(lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True))
        rec["flash_bwd_dq"]["library_ms"] = rec["flash_bwd_dkv"]["library_ms"] = bwd
        line += f", backward (dq, dk, dv) {bwd:.4f} ms"
    print(f"kernels[time sdpa window={window} D={qt.shape[-1]} {name_t}, boolean mask]: {line}",
          flush=True)


# phase 3, K5 at a query offset: the ranks of phase 20's sequence-parallel
# prefill (B = 4, S = 1,024): (label, H, KV, D, window, softcap, m, dtype)
OFFSET_CASES = [
    ("gemma3-1b m=2", 4, 1, 256, None, None, 2, torch.bfloat16),
    ("gemma3-1b m=2", 4, 1, 256, 512, None, 2, torch.bfloat16),
    ("granite-moe m=2", 16, 8, 64, None, None, 2, torch.bfloat16),
    ("gemma3-1b m=4", 4, 1, 256, 512, None, 4, torch.bfloat16),
    ("gemma3-1b m=4 softcap", 4, 1, 256, None, 50.0, 4, torch.bfloat16),
    ("gemma3-1b m=2 f32", 4, 1, 256, 512, None, 2, torch.float32),
    # the ranks of the SSM, hybrid and frontend archs: zamba2's shared block
    # at head_dim 80, musicgen's 64 and internvl2's 128 (fwd_narrow_kernel's
    # 128-key tiles), each at m = 4 too (q0 = 256 .. 768)
    ("zamba2-2.7b m=2", 32, 32, 80, None, None, 2, torch.bfloat16),
    ("internvl2-2b m=2", 16, 8, 128, None, None, 2, torch.bfloat16),
    ("musicgen-large m=2", 32, 32, 64, None, None, 2, torch.bfloat16),
    ("zamba2-2.7b m=4", 32, 32, 80, None, None, 4, torch.bfloat16),
    ("musicgen-large m=4", 32, 32, 64, None, None, 4, torch.bfloat16),
    ("internvl2-2b m=4", 16, 8, 128, None, None, 4, torch.bfloat16),
    # f32 at the tensor-core widths (fwd_tf32_kernel): granite-moe (D = 64),
    # zamba2 at m = 4 (D = 80), internvl2 (D = 128)
    ("granite-moe m=2 f32", 16, 8, 64, None, None, 2, torch.float32),
    ("zamba2-2.7b m=4 f32", 32, 32, 80, None, None, 4, torch.float32),
    ("internvl2-2b m=2 f32", 16, 8, 128, None, None, 2, torch.float32),
]
OFFSET_SEEDS = (31, 32)


def _offset_operands(g, h, kv, d, dtype, b=4, s=1024):
    return _attention(g, h, kv, dtype, b=b, s=s, d=d)[:3]


def check_flash_offset(seeds=OFFSET_SEEDS):
    """K5 at a query offset against its plain version: every rank r of m
    (queries q0 = r S/m .. q0 + S/m - 1 against the keys 0 .. q0 + S/m -
    1) of ``OFFSET_CASES``, at each seed, within ``check_flash``'s limits
    (bf16 2**-7, f32 1e-4 of the largest value, ``TF32_FWD_TOL`` at D = 64,
    80 and 128; the LSE 1e-5); and bitwise
    the same rows of the launch without an offset on the whole sequence
    (the query offset is a multiple of the kernels' query tiles, so each
    row's key tiles, in their order, are the same).  Returns the worst
    absolute error under ``flash_fwd_f32`` for the f32 cases at D = 64, 80
    and 128 (``fwd_tf32_kernel``) and under ``flash_fwd`` for the others."""
    worst = {"flash_fwd": 0.0, "flash_fwd_f32": 0.0}
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        for label, h, kv, d, window, cap, m, dtype in OFFSET_CASES:
            q, k, v = _offset_operands(g, h, kv, d, dtype)
            kw = dict(window=window, softcap=cap)
            full, full_lse = flash_ops.flash_fwd(q, k, v, **kw)
            n = q.shape[1] // m
            tc = dtype == f32 and d in flash_ops.TF32_FWD_HEAD_DIMS
            tol = 2.0 ** -7 if dtype == bf16 else TF32_FWD_TOL if tc else 1e-4
            key = "flash_fwd_f32" if tc else "flash_fwd"
            line = []
            for r in range(m):
                q0 = r * n
                args = (q[:, q0:q0 + n].contiguous(), k[:, :q0 + n].contiguous(),
                        v[:, :q0 + n].contiguous())
                out, lse = flash_ops.flash_fwd(*args, q0=q0, **kw)
                pout, plse = flash_ops.flash_fwd_plain(*args, q0=q0, **kw)
                torch.cuda.synchronize()
                err, rel = errors(out, pout)
                lse_rel = errors(lse, plse)[1]
                where = (label, window, cap, seed, r)
                assert rel <= tol and lse_rel <= 1e-5, (where, rel, lse_rel)
                assert torch.equal(out, full[:, q0:q0 + n]), ("not the whole launch's rows", where)
                assert torch.equal(lse, full_lse[:, :, q0:q0 + n]), ("lse rows", where)
                worst[key] = max(worst[key], err)
                line.append(f"r{r} q0={q0} {err:.3g}/{rel:.3g}")
            print(f"kernels[flash offset {label} seed={seed} window={window} softcap={cap} "
                  f"{str(dtype)[6:]} B=4 S=1024 H={h} KV={kv} D={d}]: max_abs_err/relative "
                  + ", ".join(line) + f" (tol {tol:.3g}, lse 1e-05); each rank bitwise the "
                  "rows of the launch without an offset", flush=True)
    return worst


def time_flash_offset(seed=33):
    """Phase 20's K5 launches timed at the last rank (the most causal
    work), bf16, B = 4, S = 1,024: gemma3-1b at m = 2 (q0 = 512; its full
    and window-512 layers) and m = 4 (q0 = 768, window 512), granite-moe,
    zamba2 (D = 80), internvl2 (D = 128) and musicgen at m = 2.  Bounds
    count the rank's visible pairs (``costs.flash_fwd_cost`` at the
    offset) and its bytes (its q, out and LSE rows, keys 0 .. q0 + S/m -
    1); the library yardstick is SDPA with the rank's boolean mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    recs = {}
    for label, h, kv, d, window, m in (("gemma3-1b m=2", 4, 1, 256, None, 2),
                                       ("gemma3-1b m=2", 4, 1, 256, 512, 2),
                                       ("gemma3-1b m=4", 4, 1, 256, 512, 4),
                                       ("granite-moe m=2", 16, 8, 64, None, 2),
                                       ("zamba2-2.7b m=2", 32, 32, 80, None, 2),
                                       ("internvl2-2b m=2", 16, 8, 128, None, 2),
                                       ("musicgen-large m=2", 32, 32, 64, None, 2)):
        q, k, v = _offset_operands(g, h, kv, d, torch.bfloat16)
        b, s = q.shape[:2]
        n = s // m
        q0 = s - n
        q = q[:, q0:].contiguous()
        cost = roofline.flash_fwd_cost(b, s, h, kv, d, window, 2, q0=q0, sq=n)
        bnd, by = roofline.bound_ms(cost)
        mask = flash_ops.visible_mask(s, window, "cuda", q0, n)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kt, vt = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        want = flash_ops.flash_fwd(q, k, v, window=window, q0=q0)[0]
        torch.testing.assert_close(sdpa().transpose(1, 2), want, rtol=2.0 ** -6, atol=2.0 ** -6)
        r = dict(ms=device_ms(lambda: flash_ops.flash_fwd(q, k, v, window=window, q0=q0)),
                 plain_ms=device_ms(lambda: flash_ops.flash_fwd_plain(q, k, v, window=window,
                                                                      q0=q0), calls=5, warmup=1),
                 bound_ms=bnd, bound_by=by, library_ms=device_ms(sdpa))
        key = f"{label} rank {m - 1} q0={q0} window={window}"
        _print_time(f"flash_fwd offset {key} B={b} H={h} KV={kv} D={d} bf16", r)
        recs[key] = r
    return recs


def federation(cfg, data, method, rounds, device, **kw):
    run_cfg = FLRunConfig(n_clients=data.n_clients, rounds=rounds, seed=0, **kw)
    params = cnn.init_params(torch.Generator().manual_seed(0), cfg, device=device)
    loss = lambda p, b: cnn.loss_fn(p, cfg, b)
    acc = masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"]))
    fed = Federation(method, loss, acc, params, data, run_cfg, device=device)
    return fed, fed.run()


def small_parity():
    """The port on the card against the port on the CPU (which the CPU
    tests hold against ``repro``): SMALL_CNN, 400 samples, K = 8."""
    images, labels = make_class_conditional_images(400, 10, 16, seed=0)
    data = FederatedData.from_partition(
        images, labels, dirichlet_partition(labels, 8, 0.3, seed=0), seed=0)
    kw = dict(participation=0.5, batch=16, local_iters=2)
    fed_g, h_g = federation(SMALL_CNN, data, PFedSOP(), 3, "cuda", **kw)
    fed_c, h_c = federation(SMALL_CNN, data, PFedSOP(), 3, "cpu", **kw)
    # same init, data and cohorts; f32 convs (TF32 off) and sums in another
    # order on the two devices -> fp32 noise amplified by 3 rounds of SGD
    np.testing.assert_allclose(h_g["loss"], h_c["loss"], rtol=1e-4)
    np.testing.assert_allclose(fed_g.client_states.params.cpu().numpy(),
                               fed_c.client_states.params.numpy(), atol=1e-4)
    print(f"small parity: cuda loss {h_g['loss']} cpu loss {h_c['loss']}", flush=True)


@functools.lru_cache(maxsize=None)
def resnet_images():
    cfg = RESNET9_CIFAR100  # 32x32, 100 classes, (64, 128, 256) widths
    return make_class_conditional_images(20_000, cfg.n_classes, cfg.cnn_image_size, seed=0)


@functools.lru_cache(maxsize=None)
def resnet_data():
    t0 = time.perf_counter()
    images, labels = resnet_images()
    parts = dirichlet_partition(labels, 100, 0.07, seed=0)
    data = FederatedData.from_partition(images, labels, parts, seed=0)
    print(f"slice: data {time.perf_counter() - t0:.1f}s", flush=True)
    return data


def fleet_data():
    """Phase 11's fleet (``profile_store.fleet_data``): client i holds the 50
    images from 50 i mod 19,950."""
    return profile_store.fleet_data(*resnet_images(), STORE_K)


def slice_run():
    cfg = RESNET9_CIFAR100
    data = resnet_data()
    kw = dict(participation=0.2, batch=50)
    pcfg = PFedSOPConfig(eta1=0.05, eta2=0.05)  # the driver's default lr

    reset_launches()
    fed_k, h_k = federation(cfg, data, PFedSOP(cfg=pcfg), 3, "cuda", **kw)
    after_pfedsop = all_launches()
    _, h_f = federation(cfg, data, FedAvg(lr=0.05), 3, "cuda", **kw)
    launches = all_launches()
    assert fed_k.layout.size == MAIN_N and fed_k.kprime == MAIN_C
    assert after_pfedsop == {**{k: 0 for k in launches}, "reduce3": 3, "update": 3}, \
        after_pfedsop
    assert launches == after_pfedsop, launches  # FedAvg launches nothing
    for name, h in (("pfedsop", h_k), ("fedavg", h_f)):
        assert all(math.isfinite(v) for v in h["loss"]), (name, h["loss"])
        for t in range(len(h["loss"])):
            print(f"slice[{name}] round {t}: loss={h['loss'][t]:.6f} "
                  f"acc={h['acc'][t]:.6f} round_time={h['round_time'][t]:.4f}s",
                  flush=True)

    _, h_r = federation(cfg, data, PFedSOP(cfg=pcfg), 2, "cuda",
                        update_impl="reference", **kw)
    assert all_launches() == launches
    # kernel vs reference update: fp32 reduction order in beta/the step,
    # plus cuDNN's run-to-run order; acc may flip one prediction of the
    # smallest test set (>= 1 sample) of one of the 20 clients
    np.testing.assert_allclose(h_r["loss"], h_k["loss"][:2], rtol=1e-4)
    np.testing.assert_allclose(h_r["acc"], h_k["acc"][:2], atol=0.05)
    print(f"slice: reference update loss {h_r['loss']} acc {h_r['acc']}", flush=True)
    return launches


def lm_small_parity():
    """The LM path on the card against the same run on the CPU (which the
    CPU tests hold against ``repro``): gemma3-1b-smoke in f32, the same
    init, 2 clients x 2 local iterations x 3 rounds, batch 2, seq_len 64.
    The card's kernels sum in another order than the CPU's plain versions:
    f32 noise through 12 SGD steps and 2 personalized updates -> loss rtol
    2e-4, beta rtol 1e-3 (an angle between two deltas)."""
    cfg = get_config("gemma3-1b", reduced=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1)
    kw = dict(clients=2, rounds=3, local_iters=2, batch=2, seq_len=64)
    h_g, _ = lm_driver.train(cfg, tree_map(lambda x: x.cuda(), params), pcfg, **kw)
    h_c, _ = lm_driver.train(cfg, params, pcfg, **kw)
    np.testing.assert_allclose(h_g["loss"], h_c["loss"], rtol=2e-4)
    np.testing.assert_allclose(h_g["beta"], h_c["beta"], rtol=1e-3)
    print(f"small LM parity: cuda loss {h_g['loss']} beta {h_g['beta']}; cpu loss "
          f"{h_c['loss']} beta {h_c['beta']}", flush=True)


def lm_slice():
    """The LM main path at gemma3-1b full width and depth; returns its
    launch counts and the per-round history."""
    cfg = get_config("gemma3-1b")
    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0)  # the example's defaults
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n = sum(x.numel() for x in tree_leaves(params))
    assert n == LM_N, n
    torch.cuda.synchronize()
    print(f"lm slice: {cfg.name} N={n} {cfg.dtype}, init {time.perf_counter() - t0:.1f}s",
          flush=True)

    def log(t, loss, beta, dt):
        print(f"lm slice round {t}: loss={loss:.6f} beta={beta:.6f} round_time={dt:.4f}s",
              flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist, states = lm_driver.train(cfg, params, pcfg, on_round=log, **LM)
    launches = all_launches()
    steps = LM["clients"] * LM["local_iters"] * LM["rounds"]
    want = {**{k: 0 for k in launches},
            **{k: steps * v for k, v in lm_driver.launches_per_step(cfg).items()}}
    want.update(reduce3=LM["clients"] * (LM["rounds"] - 1),
                update=LM["clients"] * (LM["rounds"] - 1))
    assert launches == want, (launches, want)
    assert all(math.isfinite(v) for v in hist["loss"]), hist["loss"]
    print(f"lm slice: launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # one forward of client 0's trained model, reference path against kernels
    del params
    trained = states[0].params
    states = None
    batch = next(lm_driver.client_streams(cfg, 1, LM["batch"], LM["seq_len"])[0])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with torch.no_grad():
        loss_k = tf.lm_loss(trained, cfg, batch).item()
        loss_r = tf.lm_loss(trained, cfg.replace(kernel_impl="reference"), batch).item()
    # bf16 activations rounded at other places through 26 layers: K5 rounds P
    # to bf16 before the PV product where the reference does, but its scores
    # are summed in another order and it divides by the online softmax's sum
    # of f32 probabilities at the end: rtol 1e-2 on a loss near
    # ln(262144) = 12.5
    assert abs(loss_k - loss_r) <= 1e-2 * abs(loss_r), (loss_k, loss_r)
    print(f"lm slice: forward loss kernel {loss_k:.6f} reference {loss_r:.6f} "
          f"(rel diff {abs(loss_k - loss_r) / abs(loss_r):.3g})", flush=True)
    return launches


def resnet_driver(method, rounds, mode="sync", async_cfg=None, data=None, participation=0.2,
                  **kw):
    """A driver of the ResNet slice (its width, data and sampling) on the card."""
    cfg, data = RESNET9_CIFAR100, data or resnet_data()
    run_cfg = FLRunConfig(n_clients=data.n_clients, participation=participation, batch=50,
                          rounds=rounds, seed=0, **kw)
    params = cnn.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    args = (method, lambda p, b: cnn.loss_fn(p, cfg, b),
            masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"])), params, data,
            run_cfg)
    if mode == "sync":
        return Federation(*args, device="cuda")
    return AsyncFederation(*args, async_cfg, device="cuda")


def method(name):
    # launch.train_federated's defaults
    return build_method(name, 0.05, types.SimpleNamespace(rho=1.0, lam=1.0, mu=0.1,
                                                          ditto_lam=0.1))


def methods_run():
    """Every method at the ResNet slice's width, 2 rounds each; returns the
    launch counts (one K1/K2 pair per pfedsop round: the no-PC ablation
    blends on the plain reference path, as in ``repro``)."""
    reset_launches()
    for name in METHOD_NAMES:
        fed = resnet_driver(method(name), 2)
        h = fed.run()
        assert fed.layout.size == MAIN_N and fed.kprime == MAIN_C and fed.T == 4
        assert all(math.isfinite(v) for v in h["loss"]), (name, h["loss"])
        print(f"methods[{name}]: round_time {h['round_time'][0]:.4f} "
              f"{h['round_time'][1]:.4f} s, loss {h['loss'][0]:.6f} "
              f"{h['loss'][1]:.6f}, acc {h['acc'][0]:.6f} {h['acc'][1]:.6f}", flush=True)
        del fed
    launches = all_launches()
    assert launches == {**{k: 0 for k in launches}, "reduce3": 2, "update": 2}, launches
    return launches


def _same_tensors(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def sync_vs_async():
    """The degenerate async driver against the sync driver, bit for bit."""
    for name in ("pfedsop", "fedavg"):
        sync = resnet_driver(method(name), 2)
        h_s = sync.run()
        asyn = resnet_driver(method(name), 2, mode="async")
        h_a = asyn.run()
        for key in ("loss", "acc", "sim_time", "mean_best_acc"):
            assert h_a[key] == h_s[key], (name, key, h_a[key], h_s[key])
        assert h_a["staleness"] == [0.0, 0.0] and h_a["engine"]["cohort_sizes"] == [MAIN_C]
        assert _same_tensors(asyn.broadcast, sync.broadcast), name
        assert _same_tensors(asyn.client_states, sync.client_states), name
        print(f"sync/async[{name}]: bitwise equal; loss {h_s['loss']}", flush=True)


def _async_run(**kw):
    fed = resnet_driver(method("pfedsop"), ASYNC_VERSIONS, "async", HETERO, **kw)
    dispatched = []
    dispatch = fed._dispatch
    fed._dispatch = lambda ids: dispatched.append(len(ids)) or dispatch(ids)
    t0 = time.perf_counter()
    return fed, fed.run(), dispatched, time.perf_counter() - t0


def async_run():
    """The heterogeneous async run (its launch counts), then traced and
    profiled; returns (launches, history)."""
    shutil.rmtree(SCRATCH, ignore_errors=True)  # a fresh trace directory
    reset_launches()
    fed, h, dispatched, wall = _async_run()
    launches = all_launches()
    n = len(dispatched)
    assert launches == {**{k: 0 for k in launches}, "reduce3": n, "update": n}, \
        (launches, dispatched)
    assert len(h["loss"]) == ASYNC_VERSIONS and all(math.isfinite(v) for v in h["loss"])
    assert any(h["staleness"]) and len(set(dispatched)) > 1, (h["staleness"], dispatched)
    print(f"async: {ASYNC_VERSIONS} versions in {wall:.4f} s, {n} dispatches of "
          f"{dispatched} clients (K1/K2 {launches['reduce3']}/{launches['update']})",
          flush=True)
    for v in range(ASYNC_VERSIONS):
        print(f"async version {v + 1}: sim_time={h['sim_time'][v]!r} "
              f"staleness={h['staleness'][v]!r} loss={h['loss'][v]:.6f} "
              f"acc={h['acc'][v]:.6f} round_time={h['round_time'][v]:.4f}s", flush=True)

    trace_dir = SCRATCH / "trace"
    _, h_t, _, wall_t = _async_run(obs=ObsConfig(trace_dir=str(trace_dir), level="phase"))
    for key in ("loss", "acc", "sim_time", "staleness", "mean_best_acc"):
        assert h_t[key] == h[key], (key, h_t[key], h[key])
    phases = {}
    for e in read_events(trace_dir):
        if e.get("k") == "span" and "dur" in e:
            phases[e["name"]] = phases.get(e["name"], 0) + e["dur"] / 1e3
    print(f"async traced: bitwise equal to untraced; wall {wall_t:.4f} s; phase totals "
          f"(ms, synchronized): " + ", ".join(f"{k}={v:.3f}" for k, v in phases.items()),
          flush=True)

    h_p, wall_p, busy_us = profiled_run(lambda: _async_run()[1::2])
    assert h_p["loss"] == h["loss"]
    print(f"async profiled: wall {wall_p * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / 1e3 / (wall_p * 1e3):.4f}", flush=True)
    return launches, h


def profiled_run(body):
    """``body()`` under torch.profiler; it returns (result, the wall seconds
    of the part it times, ending in a synchronize).  Returns (result, wall,
    the device's busy microseconds: the union of the device events'
    intervals).  The intervals are read from the profiler's raw events:
    ``prof.events()`` first builds a Python event tree of every host op,
    which took 90 s after phase 9's 6 s run on an H100 host."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out, wall = body()
        torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not getattr(e, "is_hidden_event", lambda: False)())
    busy_ns, end = 0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_ns += hi - max(lo, end)
            end = hi
    assert busy_ns > 0, "the profiler recorded no device event"
    return out, wall, busy_ns / 1e3


def async_resume(full):
    """Checkpoint the heterogeneous run at version 4, restore into a fresh
    driver, run on: ``full``'s history bit for bit."""
    ckpt = SCRATCH / "ckpt"
    _, h_c, _, _ = _async_run(ckpt_every=4, ckpt_dir=str(ckpt))
    assert h_c["loss"] == full["loss"]
    fed = resnet_driver(method("pfedsop"), ASYNC_VERSIONS, "async", HETERO,
                        ckpt_every=4, ckpt_dir=str(ckpt))
    assert fed.restore(step=4) == 4
    pending, buffered = len(fed._pending), len(fed._buffer)
    h_r = fed.run()
    for key in ("loss", "acc", "sim_time", "staleness", "mean_best_acc"):
        assert h_r[key] == full[key], (key, h_r[key], full[key])
    print(f"async resume: restored at version 4 with {pending} in flight and "
          f"{buffered} buffered; versions 5-{ASYNC_VERSIONS} bitwise equal", flush=True)


def _final_rows(store):
    """The store's final client rows as host tensors, one per leaf, read in
    ranges of ``STORE_RANGE`` clients as checkpoint shards stream them."""
    out = None
    for lo in range(0, store.k, STORE_RANGE):
        hi = min(lo + STORE_RANGE, store.k)
        block = [torch.as_tensor(x) for x in tree_leaves(store._host_block(lo, hi))]
        if out is None:
            out = [torch.empty((store.k,) + b.shape[1:], dtype=b.dtype) for b in block]
        for o, b in zip(out, block):
            o[lo:hi].copy_(b)
    return out


def _same_rows(store, ref):
    """Every client range of ``store`` equal to ``ref``'s (``torch.equal`` on
    the host, every thread); returns the number of ranges compared."""
    n = 0
    for lo in range(0, store.k, STORE_RANGE):
        hi = min(lo + STORE_RANGE, store.k)
        for r, b in zip(ref, tree_leaves(store._host_block(lo, hi))):
            assert torch.equal(r[lo:hi], torch.as_tensor(b)), (store.describe(), lo, hi)
        n += 1
    return n


def stores_run(async_hist):
    """Phase 11: the ResNet slice on each store at K = 1,000, bitwise against
    the device store; then phase 9's async run on the host store.  Returns
    the launch counts of the two paths."""
    t_phase = time.perf_counter()
    data = fleet_data()
    mmap_dir = SCRATCH / "store_mmap"
    runs = [("device", "device"),
            ("host", StoreConfig(kind="host", mmap_threshold_bytes=0)),
            ("mmap", StoreConfig(kind="mmap", mmap_dir=str(mmap_dir))),
            ("host+cache80", StoreConfig(kind="host", cache_clients=80,
                                         mmap_dir=str(SCRATCH / "store_promoted")))]
    ref, launches = None, {}
    for label, store in runs:
        if label in ("mmap", "host+cache80"):
            SCRATCH.mkdir(parents=True, exist_ok=True)
            free = shutil.disk_usage(SCRATCH).free
            print(f"stores[{label}]: {free / 1e9:.1f} GB free on the disk of {SCRATCH}",
                  flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        fed = resnet_driver(method("pfedsop"), 3, data=data, participation=0.02, local_iters=4,
                            store=store)
        built = time.perf_counter() - t0
        h = fed.run()
        peak = torch.cuda.max_memory_allocated()
        got = all_launches()
        assert got == {**{k: 0 for k in got}, "reduce3": 3, "update": 3}, (label, got)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        assert fed.kprime == 20 and fed.T == 4 and fed.layout.size == MAIN_N
        assert all(math.isfinite(v) for v in h["loss"]), (label, h["loss"])
        st = fed.store.stats()
        at_rest = getattr(fed.store, "at_rest_bytes",
                          sum(x.nbytes for x in tree_leaves(fed.client_states)))
        if ref is None:
            ref = (h, _final_rows(fed.store))
            compared = "reference"
        else:
            for key in ("loss", "acc", "mean_best_acc"):
                assert h[key] == ref[0][key], (label, key, h[key], ref[0][key])
            compared = f"bitwise equal to the device store ({_same_rows(fed.store, ref[1])} " \
                       f"ranges of {STORE_RANGE} clients)"
        rounds = " ".join(f"{t:.4f}" for t in h["round_time"])
        print(f"stores[{label}]: K={STORE_K} promoted={getattr(fed.store, 'promoted', False)} "
              f"built {built:.2f}s, round_time {rounds} s, h2d {st['h2d_bytes']} B, "
              f"d2h {st['d2h_bytes']} B, at rest {at_rest} B, peak device memory "
              f"{peak / 2**30:.3f} GiB; loss {h['loss']}; {compared}", flush=True)
        if store != "device" and store.cache_clients:
            hits, misses = st["cache_hits"], st["cache_misses"]
            print(f"stores[{label}]: cache hits {hits}, misses {misses}, evictions "
                  f"{st['cache_evictions']}, hit rate {hits / (hits + misses):.4f}, "
                  f"assembles {st['cache_assembles']}, insert rows "
                  f"{st['cache_insert_rows']}", flush=True)
        # a finished Federation can outlive its ``del`` until the cycle
        # collector runs (ROADMAP.md queue 3): collect it, so the next
        # store's peak memory is its own
        del fed
        gc.collect()
        shutil.rmtree(mmap_dir, ignore_errors=True)
        shutil.rmtree(SCRATCH / "store_promoted", ignore_errors=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    reset_launches()
    fed, h, dispatched, wall = _async_run(store="host")
    hetero_host = all_launches()
    n = len(dispatched)
    assert hetero_host == {**{k: 0 for k in hetero_host}, "reduce3": n, "update": n}
    for key in ("loss", "acc", "sim_time", "staleness", "mean_best_acc"):
        assert h[key] == async_hist[key], (key, h[key], async_hist[key])
    st = fed.store.stats()
    print(f"stores[async host]: phase 9's run on the host store bit for bit, {n} "
          f"dispatches, {wall:.4f} s, h2d {st['h2d_bytes']} B, d2h {st['d2h_bytes']} B",
          flush=True)
    print(f"stores: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches, hetero_host


def serve_run():
    """Phase 12: gemma3-1b prefill + greedy decode on the kernel path, held
    against a full forward and the reference path; returns its launches."""
    t_phase = time.perf_counter()
    cfg = get_config("gemma3-1b")
    b, s, steps, cap = SERVE["batch"], SERVE["prompt"], SERVE["steps"], SERVE["capacity"]
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    assert sum(x.numel() for x in tree_leaves(params)) == LM_N
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    logits, caches = tf.prefill_with_caches(params, cfg, {"tokens": prompt}, capacity=cap)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = logits.argmax(-1)
    toks, outs = [tok], []
    timed = steps - SERVE["profiled"]

    def step(t):
        nonlocal tok, caches
        out, caches = tf.decode_step(params, cfg, {"tokens": tok}, s + t, caches)
        outs.append(out)
        tok = out.argmax(-1)
        toks.append(tok)

    t0 = time.perf_counter()
    step(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in range(1, timed):
        step(t)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0

    def profiled_steps():
        t1 = time.perf_counter()
        for t in range(timed, steps):
            step(t)
        torch.cuda.synchronize()
        return None, time.perf_counter() - t1

    _, wall_p, busy_us = profiled_run(profiled_steps)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    # per layer ln1, q-norm, k-norm and ln2, plus the final norm, at the
    # prefill and at each decode step; one flash forward per prefill layer
    want = {**{k: 0 for k in launches}, "rmsnorm": (4 * cfg.n_layers + 1) * (1 + steps),
            "flash_fwd": cfg.n_layers}
    assert launches == want, (launches, want)
    assert caches["tail"][0]["pos"].shape == (512,)
    assert sorted(caches["tail"][0]["pos"].tolist()) == list(range(s + steps - 512, s + steps))
    ms = 1e3 * decode_s / (timed - 1)
    print(f"serve: {cfg.name} N={LM_N} {cfg.dtype}, batch {b}, prompt {s}, {steps} decode "
          f"steps, capacity {cap}: prefill {1e3 * prefill_s:.3f} ms, first decode step "
          f"{1e3 * first_s:.3f} ms, decode {ms:.3f} ms/step over steps 1-{timed - 1}, "
          f"{b * (timed - 1) / decode_s:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.3f} GiB; {SERVE['profiled']} profiled steps: wall "
          f"{1e3 * wall_p:.3f} ms, device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e3 / (wall_p * 1e3):.4f}; launches {launches}", flush=True)

    # the first decode step against a full forward over prompt + token
    with torch.no_grad():
        hidden, _ = tf.forward(params, cfg, {"tokens": torch.cat([prompt, toks[0]], 1)})
        full = tf.lm_logits(params, cfg, hidden[:, -1:])
    del hidden
    err, rel = errors(outs[0], full)
    assert rel <= SERVE_RTOL, ("first decode step vs full forward", err, rel)
    print(f"serve: first decode step against the full forward: max_abs_err {err:.4g}, "
          f"relative {rel:.4g} (tol {SERVE_RTOL:.4g})", flush=True)

    # the reference path, teacher-forced on the kernel path's tokens
    ref_cfg = cfg.replace(kernel_impl="reference")
    r_logits, r_caches = tf.prefill_with_caches(params, ref_cfg, {"tokens": prompt}, capacity=cap)
    worst = [errors(logits, r_logits)[1]]
    agree = 0
    for t in range(steps):
        r_out, r_caches = tf.decode_step(params, ref_cfg, {"tokens": toks[t]}, s + t, r_caches)
        worst.append(errors(outs[t], r_out)[1])
        agree += int((r_out.argmax(-1) == toks[t + 1]).sum())
    assert max(worst) <= SERVE_RTOL, ("kernel vs reference logits", worst)
    print(f"serve: reference path teacher-forced: worst relative logit error "
          f"{max(worst):.4g} over prefill + {steps} steps (tol {SERVE_RTOL:.4g}), greedy "
          f"tokens agree {agree}/{b * steps}", flush=True)
    del params, caches, r_caches, outs, full
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--full", "--arch", "gemma3-1b",
         "--batch", "4", "--steps", "32"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")})
    for line in cli.stdout.splitlines():
        print(f"serve[cli]: {line}", flush=True)
    assert cli.returncode == 0 and cli.stdout.rstrip().endswith("OK"), cli.stderr[-4000:]
    print(f"serve: cli {time.perf_counter() - t0:.1f}s; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches


# Phase 13's archs and client counts.  In bf16 trees of N: a client holds 2
# (params and delta), the global delta 2 (f32), and the round start adds 8
# (three flat f32 inputs and the update's output): 10 + 2 C at the peak.
# zamba2 (N = 1,981,756,080, 3.69 GiB a tree) peaked at 51.762 GiB allocated
# with 2 clients (14 trees); each further client adds 7.38 GiB, and the caching
# allocator held up to 21.8 GiB reserved but unallocated in this phase after
# the earlier ones (79.2 GiB usable): 2 clients reckon 51.8 + 21.8 = 73.6
# GiB, 3 clients 59.1 + 21.8 = 80.9 GiB (a 3-client run ran out), so 2.
ARCH_TRAIN = {"granite-moe-1b-a400m": (4, 1_334_628_352), "zamba2-2.7b": (2, 1_981_756_080)}
# Phase 13's kernel path against the reference path on the trained model:
# the loss's relative gap and the gradient's |g_k - g_r| / |g_r| (all
# leaves).  The sound runs on an H100 read 2.324e-6 / 2.498e-6 and 1.211e-3
# / 4.079e-3 (zamba2 / granite-moe; PERF.md, Findings): the limits
# are 4x the larger reading.  The loss is read over the first batch of each
# of ``TRAIN_LOSS_BATCHES`` client streams (4,096 tokens each, client 0's
# first), each path routing its own tokens.  The loss gap is held to its
# limit where the model routes no tokens to experts (zamba2).  Where it does
# (granite-moe), about half the tokens take other top-k experts at some
# layer on the two paths, and a few of them move the trained model's loss by
# as much as a 1 % fault of a kernel does: over 16 client batches (four
# groups of four) the gap read up to 5.3e-4 on sound kernels, and K5's
# output x1.01 from 1.3e-4 (PERF.md, Findings), so there it is printed
# only.  Held on both: each token's NLL against an f32 run of the
# reference path, the median |error| of the kernel path over the reference
# path's (``train_loss_check``), as phase 15 holds the gradient against f32.
# The median is the typical token's, which the few tokens whose experts flip
# do not move.  Sound kernels read 0.935 to 1.011 on both archs, over all
# 16 batches of the models that these kernels and the earlier generic D = 64
# backward kernels train; K5's or K4's output x1.01 (``TRAIN_FAULTS``) reads
# 1.131 to 2.073 on granite-moe: the limit sits between, and phase 13 plants
# both on each routed model.  On zamba2 K5's fault moves neither number (its
# shared attention feeds 9 of its 54 layers), K4's reads 1.78 to 1.84.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LOSS_BATCHES = 4
TRAIN_NLL_RATIO_TOL = 1.06
TRAIN_FAULTS = ("K5 output x1.01", "K4 output x1.01")  # keys of ``GRAD_FAULTS``
TRAIN_GRAD_RTOL = 1.6e-2
# Phase 14: batch 4, a 1,024-position prompt, 32 greedy steps
ARCH_SERVE = dict(batch=4, prompt=1024, steps=32)
ARCH_SERVE_N = {"zamba2-2.7b": 1_981_756_080, "internvl2-2b": 1_701_695_488,
                "musicgen-large": 3_254_978_560}


def loss_and_grads(cfg, leaves, treedef, batch, f32=False):
    """(loss, gradient leaves) of ``tf.lm_loss`` at ``leaves`` (cast to f32
    with ``f32``)."""
    ps = [(x.float() if f32 else x).detach().requires_grad_() for x in leaves]
    loss = tf.lm_loss(tree_unflatten(treedef, ps), cfg, batch)
    return loss.item(), torch.autograd.grad(loss, ps)


def _tree_gap(got, want):
    """|got - want| / |want| over every leaf, in f32."""
    diff = sum(((a.float() - b.float()) ** 2).sum().item() for a, b in zip(got, want))
    norm = sum((b.float() ** 2).sum().item() for b in want)
    assert norm > 0 and math.isfinite(norm), norm
    return math.sqrt(diff / norm)


@contextlib.contextmanager
def planted(plants):
    """``plants`` (``GRAD_FAULTS``' (module, attribute, wrapper) triples) in
    place inside the ``with``."""
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in plants]
    try:
        for mod, attr, wrap in plants:
            setattr(mod, attr, wrap(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def token_nll(params, cfg, batch):
    """(each token's next-token NLL in f32, ``tf.lm_loss``: their mean plus
    the MoE aux loss) from one forward of a model with no frontend."""
    assert cfg.frontend == "none", cfg.frontend
    with torch.no_grad():
        hidden, aux = tf.forward(params, cfg, batch)
        logits = tf.lm_logits(params, cfg, hidden).float()
    gold = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    return nll, nll.mean().item() + tf.AUX_LOSS_COEF * aux.item()


def train_loss_check(params, cfg, ref_cfg, batches, faults=()):
    """Phase 13's loss check on ``batches``: the kernel path (``cfg``), the
    reference path (``ref_cfg``) and an f32 run of the reference path, each
    routing its own tokens.  Returns (the mean loss's relative gap between
    the kernel and reference paths, the median over the tokens of the
    kernel path's |NLL error| against the f32 run over the reference
    path's, the same ratio under each planted fault of ``faults`` (keys of
    ``GRAD_FAULTS``), a line that gives them with each batch's gap)."""
    f32 = tree_map(lambda x: x.float(), params)
    truth = torch.cat([token_nll(f32, ref_cfg.replace(dtype="float32"), x)[0].flatten()
                       for x in batches])
    del f32

    def run(c):  # (each batch's loss, the median |NLL error| against f32)
        out = [token_nll(params, c, x) for x in batches]
        nll = torch.cat([o[0].flatten() for o in out])
        return [o[1] for o in out], (nll - truth).abs().median().item()

    (loss_k, err_k), (loss_r, err_r) = run(cfg), run(ref_cfg)
    r = sum(loss_r) / len(batches)

    def gap(losses):
        return abs(sum(losses) / len(batches) - r) / abs(r)

    planted_ratios, planted_gaps = {}, {}
    for name in faults:
        with planted(GRAD_FAULTS[name]):
            losses, err = run(cfg)
        planted_ratios[name], planted_gaps[name] = err / err_r, gap(losses)
    k, ratio = sum(loss_k) / len(batches), err_k / err_r
    line = (f"mean loss over {len(batches)} client batches {k:.6f} / {r:.6f} (rel diff "
            f"{gap(loss_k):.4g}, tol {TRAIN_LOSS_RTOL:.4g} where no token is routed; each batch's "
            f"{', '.join(f'{abs(a - b) / abs(b):.4g}' for a, b in zip(loss_k, loss_r))}); each "
            f"token's NLL against an f32 run, median |error| {err_k:.4g} / {err_r:.4g}: ratio "
            f"{ratio:.4g} (tol {TRAIN_NLL_RATIO_TOL:.4g})")
    if faults:
        line += "; planted " + ", ".join(f"{n} {v:.4g} (loss rel diff {planted_gaps[n]:.4g})"
                                         for n, v in planted_ratios.items())
    return gap(loss_k), ratio, planted_ratios, line


def arch_train(arch):
    """``train_lm_pfedsop`` at ``arch``'s full width and depth, ``LM``'s loop
    (3 rounds, batch 2, seq_len 2048, 2 local iterations, eta 0.1, seed 0)
    with ``ARCH_TRAIN``'s clients and the exact launch counts.  Returns
    (the config, client 0's trained params, the launches)."""
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, fragmented
    cfg = get_config(arch)
    clients, n_want = ARCH_TRAIN[arch]
    run = dict(LM, clients=clients)
    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n = sum(x.numel() for x in tree_leaves(params))
    assert n == n_want, (arch, n)
    tree_bytes = sum(x.nbytes for x in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"train[{arch}]: N={n}, {tree_bytes} bytes a tree ({cfg.dtype}; the SSM's A_log, "
          f"dt_bias and D in f32), {clients} clients: {2 * clients * tree_bytes} bytes of "
          f"client state", flush=True)

    def log(t, loss, beta, dt):
        print(f"train[{arch}] round {t}: loss={loss:.6f} beta={beta:.6f} round_time={dt:.4f}s",
              flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    init, params = [params], None  # the driver's reference is the last one
    hist, states = lm_driver.train(cfg, init.pop(), pcfg, on_round=log, **run)
    launches = all_launches()
    steps = clients * run["local_iters"] * run["rounds"]
    want = {**{k: 0 for k in launches},
            **{k: steps * v for k, v in lm_driver.launches_per_step(cfg).items()},
            "reduce3": clients * (run["rounds"] - 1), "update": clients * (run["rounds"] - 1)}
    assert launches == want, (arch, launches, want)
    assert all(math.isfinite(v) for v in hist["loss"]), hist["loss"]
    print(f"train[{arch}]: launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return cfg, states[0].params, launches


def train_loss_batches(cfg, n):
    """The first batch of each of ``n`` client streams at ``LM``'s shape, on
    the card (client 0's first)."""
    return [{k: torch.from_numpy(v).cuda() for k, v in next(stream).items()}
            for stream in lm_driver.client_streams(cfg, n, LM["batch"], LM["seq_len"])]


def arch_train_run(arch):
    """Phase 13: ``arch_train``, then client 0's trained model on the
    reference path against the kernel path: its logits and gradient on
    client 0's first batch, and ``train_loss_check`` over the first batch of
    ``TRAIN_LOSS_BATCHES`` client streams, each planted fault of
    ``TRAIN_FAULTS`` failing it where the model routes tokens to experts.
    Returns the launches."""
    t_phase = time.perf_counter()
    cfg, trained, launches = arch_train(arch)
    batches = train_loss_batches(cfg, TRAIN_LOSS_BATCHES)
    batch = batches[0]  # client 0's first batch
    ref_cfg = cfg.replace(kernel_impl="reference")
    leaves, treedef = tree_flatten(trained)

    def logits(c):
        with torch.no_grad():
            return tf.lm_logits(trained, c, tf.forward(trained, c, batch)[0])

    # per-token logits, as phase 12 holds them: within 2**-4 of the largest
    err, rel = errors(logits(cfg), logits(ref_cfg))
    assert rel <= SERVE_RTOL, (arch, "kernel vs reference logits", err, rel)
    # the gradient on client 0's batch within 4x the sound runs' readings,
    # and the loss check over every batch
    _, grads_k = loss_and_grads(cfg, leaves, treedef, batch)
    _, grads_r = loss_and_grads(ref_cfg, leaves, treedef, batch)
    grad_rel = _tree_gap(grads_k, grads_r)
    del grads_k, grads_r
    loss_rel, ratio, faults, line = train_loss_check(
        trained, cfg, ref_cfg, batches, TRAIN_FAULTS if cfg.n_experts else ())
    print(f"train[{arch}]: client 0's trained model, kernel path against the reference "
          f"path: logits max_abs_err {err:.4g}, relative {rel:.4g} (tol {SERVE_RTOL:.4g}); "
          f"{line}; gradient |g_k - g_r| / |g_r| {grad_rel:.4g} (tol {TRAIN_GRAD_RTOL:.4g}) "
          f"over {len(leaves)} leaves; phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    assert cfg.n_experts or loss_rel <= TRAIN_LOSS_RTOL, (arch, line)
    assert ratio <= TRAIN_NLL_RATIO_TOL, (arch, line)
    assert all(v > TRAIN_NLL_RATIO_TOL for v in faults.values()), (arch, "a fault passes", line)
    assert grad_rel <= TRAIN_GRAD_RTOL, (arch, "gradient", grad_rel)
    del trained, batch, batches, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_launches(cfg, steps):
    """K4 and K5 launches of a prefill and ``steps`` decode steps: per pass
    ln1 and ln2 (and q/k-norm) of every attention sublayer, ln1 of every SSM
    sublayer and the final norm; one flash forward per attention sublayer of
    the prefill."""
    norms = sum(1 if s.kind == "ssm" else (4 if cfg.use_qk_norm else 2)
                for s in cfg.layers) + 1
    return {"rmsnorm": norms * (1 + steps),
            "flash_fwd": sum(s.kind != "ssm" for s in cfg.layers)}


def arch_serve_run(arch):
    """Phase 14: ``arch`` at full width and depth, batch 4, a 1,024-position
    random prompt (internvl2: 256 patch embeddings + 768 text tokens;
    musicgen: 4 codebooks, the int8 KV cache), 32 greedy steps through
    ``prefill_with_caches`` and ``decode_step`` with the exact K4/K5
    counts; the first decode step against a full forward over prompt +
    token; the reference path teacher-forced, every step within 2**-4 of
    the largest logit.  Returns the launches."""
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    b, s_all, steps = ARCH_SERVE["batch"], ARCH_SERVE["prompt"], ARCH_SERVE["steps"]
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n = sum(x.numel() for x in tree_leaves(params))
    assert n == ARCH_SERVE_N[arch], (arch, n)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = {}
    for name, (shape, dtype) in lm_steps.token_batch(cfg, b, s_all).items():
        if name == "tokens":
            prompt[name] = torch.randint(0, cfg.vocab_size, shape, generator=g, device="cuda")
        elif name == "patch_embeds":
            prompt[name] = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    step_batch = {k: torch.zeros(shape, dtype=dt, device="cuda")
                  for k, (shape, dt) in lm_steps.decode_batch(cfg, b).items()}
    cap = s_all + steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    logits, caches = tf.prefill_with_caches(params, cfg, prompt, capacity=cap)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks, outs = [logits.argmax(-1)], []
    t0 = time.perf_counter()
    for t in range(steps):
        step_batch["tokens"] = lm_steps.next_tokens(cfg, toks[-1])
        out, caches = tf.decode_step(params, cfg, step_batch, s_all + t, caches)
        outs.append(out)
        toks.append(out.argmax(-1))
        if t == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    first_s = t1 - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {**{k: 0 for k in launches}, **serve_launches(cfg, steps)}
    assert launches == want, (arch, launches, want)
    ms = 1e3 * decode_s / (steps - 1)
    print(f"serve[{arch}]: N={n} {cfg.dtype}, batch {b}, prompt {s_all} positions, {steps} "
          f"decode steps, capacity {cap}: prefill {1e3 * prefill_s:.3f} ms, first decode "
          f"step {1e3 * first_s:.3f} ms, decode {ms:.3f} ms/step over steps 1-{steps - 1}, "
          f"{b * (steps - 1) / decode_s:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}", flush=True)

    # the first decode step against a full forward over prompt + token
    full_in = dict(prompt, tokens=torch.cat([prompt["tokens"],
                                             lm_steps.next_tokens(cfg, toks[0])], -1))
    with torch.no_grad():
        hidden, _ = tf.forward(params, cfg, full_in)
        full = tf.lm_logits(params, cfg, hidden[:, -1:])
    del hidden
    err, rel = errors(outs[0], full)
    assert rel <= SERVE_RTOL, (arch, "first decode step vs full forward", err, rel)
    print(f"serve[{arch}]: first decode step against the full forward: max_abs_err "
          f"{err:.4g}, relative {rel:.4g} (tol {SERVE_RTOL:.4g})", flush=True)

    # the reference path, teacher-forced on the kernel path's tokens
    ref_cfg = cfg.replace(kernel_impl="reference")
    r_logits, r_caches = tf.prefill_with_caches(params, ref_cfg, prompt, capacity=cap)
    worst = [errors(logits, r_logits)[1]]
    agree = 0
    for t in range(steps):
        step_batch["tokens"] = lm_steps.next_tokens(cfg, toks[t])
        r_out, r_caches = tf.decode_step(params, ref_cfg, step_batch, s_all + t, r_caches)
        worst.append(errors(outs[t], r_out)[1])
        agree += int((r_out.argmax(-1) == toks[t + 1]).sum())
    assert max(worst) <= SERVE_RTOL, (arch, "kernel vs reference logits", worst)
    print(f"serve[{arch}]: reference path teacher-forced: worst relative logit error "
          f"{max(worst):.4g} over prefill + {steps} steps (tol {SERVE_RTOL:.4g}), greedy "
          f"tokens agree {agree}/{toks[1].numel() * steps}; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    del params, caches, r_caches, outs, full, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 15: phase 6's local work for one client, as a train step
LAUNCH_SHAPE = InputShape("lm_slice", seq_len=LM["seq_len"],
                          global_batch=LM["local_iters"] * LM["batch"], kind="train")
PEAK_RTOL = 0.10  # predicted against measured peak device memory
ROOT = Path(__file__).resolve().parent
SCRIPTS = (  # (path, launches of K1 and of K2 it must make, or None)
    ("scripts/torch_smoke_models.py", None),
    ("scripts/torch_smoke_fl.py", None),
    ("examples/torch_quickstart.py", 48),  # 2 clients x the 24 rounds after round 0
)


# Phase 15's check that the kernel path is right, on the first local step's
# gradient at the random init (bf16).  There the kernel path and the reference
# path (``kernel_impl="reference"``) each sit ~2e-2 from the gradient an f32
# run of the reference path gives, so |g_k - g_r| / |g_r| reads 1.8e-2 on a
# sound run, and the step's new global delta, (x0 - xT) / eta of bf16
# parameters whose updates are mostly below an ulp, reads 5.7e-2: both are
# bf16 noise, too coarse to tell a kernel fault.  Two numbers per leaf do
# (PERF.md, Findings, PR 18): the scale drift
# <g_k - g_r, g_r> / |g_r|^2 and, on the leaves of at least
# GRAD_RATIO_NUMEL elements (a norm's scale is too small a sample), the kernel
# path's error against the f32 gradient over the reference path's.  On an
# H100 the sound run reads 8.4e-4 and 1.005, and each planted fault of
# ``GRAD_FAULTS`` reads above 1e-2 or 1.05 (the window faults: 2.7e-3 and
# 1.30, 2.4e-3 and 1.52): the limits sit between.
GRAD_SCALE_TOL = 5e-3
GRAD_RATIO_TOL = 1.03
GRAD_RATIO_NUMEL = 2 ** 16


def _times(fn, factor, first_only=False):
    """``fn`` with each tensor it returns (only the first, with
    ``first_only``) multiplied by ``factor``."""
    def wrapped(*a):
        out = fn(*a)
        if not isinstance(out, tuple):
            return out * factor
        return tuple(t * factor if i == 0 or not first_only else t for i, t in enumerate(out))
    return wrapped


def _window_less_one(fn, n_before):
    """``fn`` with its ``window`` argument (after ``n_before`` tensors) one
    smaller."""
    def wrapped(*a):
        a = list(a)
        if a[n_before] is not None:
            a[n_before] -= 1
        return fn(*a)
    return wrapped


# planted faults: (module, attribute, wrapper), each wrapper a kernel of the
# step slightly off, as a wrong constant, operand or mask in its wiring would be
GRAD_FAULTS = {
    "K5 output x1.01": ((flash_ops, "flash_fwd", lambda f: _times(f, 1.01, first_only=True)),),
    "K5 window - 1": ((flash_ops, "flash_fwd", lambda f: _window_less_one(f, 3)),),
    "K6 dq x1.01": ((flash_ops, "flash_bwd_dq", lambda f: _times(f, 1.01)),),
    "K7 dk, dv x1.01": ((flash_ops, "flash_bwd_dkv", lambda f: _times(f, 1.01)),),
    "K7 sum pass x1.01": ((flash_ops, "flash_bwd_dkv_sum", lambda f: _times(f, 1.01)),),
    "K6, K7 window - 1": ((flash_ops, "flash_bwd_dq", lambda f: _window_less_one(f, 6)),
                          (flash_ops, "flash_bwd_dkv", lambda f: _window_less_one(f, 6))),
    "K4 output x1.01": ((rms_ops, "rmsnorm_fwd", lambda f: _times(f, 1.01)),),
}


# phase 15's archs: arch -> (its parameter count, the planted faults of
# ``GRAD_FAULTS`` its gradient check must fail, the dtype the step runs in).
# gemma3-1b (D = 256, 22 of 26 layers at window 512) takes them all;
# internvl2-2b (D = 128, the narrow forward and backward, no window, so no
# window fault applies) those of the kernels it runs at D = 128;
# granite-moe-1b-a400m runs at dtype float32 (every LM entry point's default
# through ``reduced()``, and the port's parity contract with repro): K5, K6
# and K7 at D = 64, G = 2 on the f32 tensor-core kernels (no sum pass in
# f32)
LAUNCH_ARCHS = {
    "gemma3-1b": (LM_N, tuple(GRAD_FAULTS), "bfloat16"),
    "internvl2-2b": (ARCH_SERVE_N["internvl2-2b"],
                     ("K5 output x1.01", "K6 dq x1.01", "K7 dk, dv x1.01", "K7 sum pass x1.01"),
                     "bfloat16"),
    "granite-moe-1b-a400m": (ARCH_TRAIN["granite-moe-1b-a400m"][1],
                             ("K5 output x1.01", "K6 dq x1.01", "K7 dk, dv x1.01",
                              "K4 output x1.01"), "float32"),
}
# In f32 the reference path is the f32 run itself, so ``grad_gaps``' ratio
# (against an f32 run) has nothing to divide by.  The f32 check holds, per
# leaf, |g_k - g_r| / |g_r| and the scale drift <g_k - g_r, g_r> / |g_r|^2
# (``f32_grad_gaps``).  On an H100 granite-moe's sound step reads 2.8e-6 and
# 2.0e-6, and the faults of K5, K6, K7 and K4 (x1.01) 1.0e-2 to 7.4e-2 (the
# smallest, K6's: 1.03e-2 and 1.02e-2): both limits sit between, about 60x
# above the sound reading and 50x below the smallest fault's (PERF.md,
# Findings).
F32_GRAD_RTOL = 2e-4
F32_SCALE_TOL = 2e-4


def f32_grad_gaps(g_k, g_r):
    """The f32 kernel path's gradient ``g_k`` against the f32 reference
    path's ``g_r``: (the largest |<g_k - g_r, g_r>| / |g_r|^2, the largest
    |g_k - g_r| / |g_r|) over the leaves whose reference is not zero."""
    scale = gap = 0.0
    for k, r in zip(g_k, g_r):
        k, r = k.float(), r.float()
        rr = (r * r).sum().item()
        if rr > 0:
            scale = max(scale, abs(((k - r) * r).sum().item()) / rr)
            gap = max(gap, ((k - r).norm() / r.norm()).item())
    return scale, gap


def grad_gaps(g_k, g_r, g_t):
    """The kernel path's gradient ``g_k`` against the reference path's ``g_r``
    and the f32 one ``g_t``: (the largest |<g_k - g_r, g_r>| / |g_r|^2 over the
    leaves, the largest |g_k - g_t| / |g_r - g_t| over the leaves of at least
    ``GRAD_RATIO_NUMEL`` elements)."""
    scale = ratio = 0.0
    for k, r, t in zip(g_k, g_r, g_t):
        k, r, t = k.float(), r.float(), t.float()
        scale = max(scale, abs(((k - r) * r).sum().item()) / (r * r).sum().item())
        if r.numel() >= GRAD_RATIO_NUMEL:
            ratio = max(ratio, ((k - t).norm() / (r - t).norm()).item())
    return scale, ratio


def launch_step_batches(cfg, device="cuda"):
    """One client's ``LM["local_iters"]`` batches at phase 6's shape, each
    leaf (1, T, ...): client 0's first batches of phase 6's stream for a
    text arch; for the vision frontend, whose batches the LM driver's streams
    do not make, tokens and labels uniform over the vocabulary and patch
    embeddings standard normal, from seed 0, in ``steps.token_batch``'s
    layout (the patches take ``n_patches`` of the ``seq_len`` positions)."""
    t, b, s = LM["local_iters"], LM["batch"], LM["seq_len"]
    if cfg.frontend == "none":
        stream = lm_driver.client_streams(cfg, 1, b, s)[0]
        bs = [next(stream) for _ in range(t)]
        return {k: torch.from_numpy(np.stack([x[k] for x in bs])[None]).to(
            device=device, dtype=torch.int32) for k in bs[0]}
    assert cfg.frontend == "vision_stub", cfg.frontend
    rng = np.random.default_rng(0)
    out = {}
    for k, (shape, dtype) in lm_steps.token_batch(cfg, b, s).items():
        shape = (1, t) + shape
        x = (rng.integers(0, cfg.vocab_size, shape) if dtype == torch.int32
             else rng.standard_normal(shape, dtype=np.float32))
        out[k] = torch.from_numpy(x).to(device=device, dtype=dtype)
    return out


def launch_step_args(cfg, n=LM_N):
    """``make_train_step``'s inputs at phase 6's shape on the card: one
    client's params from seed 0 (``n`` of them, unchecked for None) and
    zero local and global deltas, and its batches (``launch_step_batches``)."""
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    assert n is None or sum(x.numel() for x in tree_leaves(params)) == n
    state = {"params": tree_map(lambda x: x.unsqueeze(0), params),
             "delta": tree_map(lambda x: torch.zeros_like(x).unsqueeze(0), params)}
    global_delta = tree_map(torch.zeros_like, params)
    return state, global_delta, launch_step_batches(cfg)


def launch_tooling_run(archs=tuple(LAUNCH_ARCHS)):
    """Phase 15: ``launch_step_check`` for each arch of ``archs`` (keys of
    ``LAUNCH_ARCHS``).  Returns {arch (``<arch>-f32`` for an f32 step): the
    step's launches}."""
    return {(arch if dtype == "bfloat16" else f"{arch}-f32"):
            launch_step_check(arch, n, faults, dtype)
            for arch, (n, faults, dtype) in LAUNCH_ARCHS.items() if arch in archs}


def launch_step_check(arch, n, faults, dtype="bfloat16"):
    """The dry run's prediction for ``steps.make_train_step`` at phase 6's
    shape (one client, B = 2, S = 2048, T = 2, remat "block") on ``arch``
    in ``dtype`` (the published config's bf16, or float32), then the step
    on the card at full width and depth (``n`` parameters): the launches
    must equal the prediction's, the peak device memory be within
    ``PEAK_RTOL`` of the predicted peak, and the loss within phase 13's
    limit of the reference path's.  The first local step's gradient is held
    per leaf (bf16: ``grad_gaps``; f32: ``f32_grad_gaps``), and each planted
    fault of ``faults`` (keys of ``GRAD_FAULTS``) must fail that check.
    Prints the wall and device time and the idle share of a profiled step,
    its device time by kernel family (``profile_lm_step.family``), the
    counted FLOPs against ``model_flops``, the roofline terms and the new
    global delta's gap.  Returns the step's launches."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    assert cfg.remat == "block" and cfg.dtype == "bfloat16", (cfg.remat, cfg.dtype)
    f32_step = dtype == "float32"
    if f32_step:
        cfg = cfg.replace(dtype=dtype)
        arch_tag = f"{arch} f32"
    else:
        assert dtype == "bfloat16", dtype
        arch_tag = arch
    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0)
    t0 = time.perf_counter()
    rec = dryrun.run_one(arch, LAUNCH_SHAPE, micro_batch=LM["batch"], save=False,
                         verbose=False, cfg=cfg if f32_step else None)
    mem = rec["memory_analysis"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    print(f"launch[{arch_tag} dryrun]: {rec['ops']} ops counted on the meta device in "
          f"{time.perf_counter() - t0:.1f}s: launches {rec['launches']}; memory {mem}, "
          f"peak {predicted} bytes ({predicted / 2**30:.3f} GiB), fits={rec['fits']}; "
          f"flops {rec['cost_analysis']['flops']:.6g}, bytes "
          f"{rec['cost_analysis']['bytes accessed']:.6g}", flush=True)

    base = torch.cuda.memory_allocated()
    args = launch_step_args(cfg, n)
    state, global_delta, batches = args
    held = sum(x.untyped_storage().nbytes() for x in tree_leaves(args))
    assert held == mem["argument_size_in_bytes"], (held, mem)
    step = lm_steps.make_train_step(cfg, LAUNCH_SHAPE, pcfg)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    new_state, new_global, loss = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    measured = torch.cuda.max_memory_allocated() - base
    want = {**{k: 0 for k in launches}, **rec["launches"]}
    print(f"launch[{arch_tag} step]: wall {1e3 * wall:.3f} ms; launches {launches} (predicted "
          f"{rec['launches']}); peak device memory {measured} bytes ({measured / 2**30:.3f} "
          f"GiB) against the predicted {predicted} ({predicted / 2**30:.3f} GiB): "
          f"{100 * (predicted - measured) / measured:+.2f}% (tol "
          f"{100 * PEAK_RTOL:.0f}%)", flush=True)
    assert launches == want, (launches, want)
    assert abs(predicted - measured) <= PEAK_RTOL * measured, (predicted, measured)

    walls = []

    def again():
        t = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)

    events = profiled(again, [torch.profiler.ProfilerActivity.CUDA])
    busy = sum(e.self_device_time_total for e in events) / 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"launch[{arch_tag} step, profiled, {smi}]: wall {1e3 * walls[-1]:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / (1e3 * walls[-1]):.4f}", flush=True)
    by_family = collections.Counter()
    for e in events:
        by_family[profile_lm_step.family(e.key)] += e.self_device_time_total / 1e3
    print(f"launch[{arch_tag} step, device ms by kernel family (profile_lm_step.FAMILIES)]: "
          + ", ".join(f"{fam} {ms:.3f}" for fam, ms in by_family.most_common()), flush=True)
    rl = rec["roofline"]
    mf = roofline.model_flops(cfg, LAUNCH_SHAPE)
    print(f"launch[{arch_tag} roofline]: device busy {busy:.3f} ms of the step (profiled run); counted "
          f"FLOPs {rl['total_flops']:.6g} against model_flops {mf:.6g} (useful "
          f"{mf / rl['total_flops']:.3f}); counted bytes {rl['total_bytes']:.6g}; terms "
          f"compute {1e3 * rl['compute_s']:.3f} ms, memory {1e3 * rl['memory_s']:.3f} ms, "
          f"dominant {rl['dominant']}; the compute term is "
          f"{100 * 1e3 * rl['compute_s'] / busy:.1f}% of the step's device time and the memory "
          f"term {100 * 1e3 * rl['memory_s'] / busy:.1f}%", flush=True)

    ref_cfg = cfg.replace(kernel_impl="reference")
    ref_pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0, update_impl="reference")
    _, ref_global, ref_loss = lm_steps.make_train_step(ref_cfg, LAUNCH_SHAPE, ref_pcfg)(*args)
    loss_k, loss_r = loss.item(), ref_loss.item()
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    delta_rel = _tree_gap(tree_leaves(new_global), tree_leaves(ref_global))
    print(f"launch[{arch_tag} step]: kernel path against the reference path: loss {loss_k:.6f} / "
          f"{loss_r:.6f} (rel diff {loss_rel:.4g}, tol {TRAIN_LOSS_RTOL:.4g}); new global "
          f"delta |d_k - d_r| / |d_r| {delta_rel:.4g} (printed only"
          f"{'' if f32_step else ': bf16 rounding of sub-ulp updates'})", flush=True)
    assert math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_RTOL, (loss_k, loss_r)
    del new_state, new_global, ref_global

    # the first local step's gradient, per leaf, against the reference path
    # (bf16: and an f32 run of it, ``grad_gaps``; f32: the reference path is
    # the f32 run, ``f32_grad_gaps``); then each planted fault of ``faults``
    # must fail the same check
    leaves, treedef = tree_flatten(tree_map(lambda x: x[0], state["params"]))
    first = {k: v[0, 0] for k, v in batches.items()}
    del state, global_delta, args
    l_r, g_r = loss_and_grads(ref_cfg, leaves, treedef, first)
    if f32_step:
        g_t = None
        gaps = lambda g: f32_grad_gaps(g, g_r)  # noqa: E731
        tols, second = (F32_SCALE_TOL, F32_GRAD_RTOL), "|g_k - g_r| / |g_r|"
    else:
        l_t, g_t = loss_and_grads(ref_cfg.replace(dtype="float32"), leaves, treedef, first,
                                  f32=True)
        gaps = lambda g: grad_gaps(g, g_r, g_t)  # noqa: E731
        tols, second = ((GRAD_SCALE_TOL, GRAD_RATIO_TOL),
                        "error against f32 over the reference path's")
    l_k, g_k = loss_and_grads(cfg, leaves, treedef, first)
    scale, other = gaps(g_k)
    against = ("" if f32_step else f" / {l_t:.6f}; against the f32 path "
               f"{_tree_gap(g_k, g_t):.4g} / {_tree_gap(g_r, g_t):.4g}")
    print(f"launch[{arch_tag} step]: its first local step, kernel / reference path"
          f"{'' if f32_step else ' / f32 path'}: loss {l_k:.7f} / {l_r:.7f}{against}; gradient "
          f"|g_k - g_r| / |g_r| {_tree_gap(g_k, g_r):.4g} (printed only); per leaf: scale "
          f"drift {scale:.4g} (tol {tols[0]:.4g}), {second} {other:.4g} (tol {tols[1]:.4g})",
          flush=True)
    assert scale <= tols[0] and other <= tols[1], (scale, other)
    del g_k
    for name in faults:
        with planted(GRAD_FAULTS[name]):
            _, g_f = loss_and_grads(cfg, leaves, treedef, first)
        f_scale, f_other = gaps(g_f)
        print(f"launch[{arch_tag} step]: planted fault {name}: scale drift {f_scale:.4g}, "
              f"{second} {f_other:.4g}", flush=True)
        assert f_scale > tols[0] or f_other > tols[1], (name, f_scale, f_other)
        del g_f
    print(f"launch[{arch_tag} step]: the check fails each of the {len(faults)} planted faults; "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    del batches, leaves, g_r, g_t, gaps
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_tiny_update():
    """K1/K2 at the quickstart's C = 1, N = 4 (one tile of 4,096 holds the
    whole row) against their plain versions, f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        x, di, dg = make_operands(1, 4, dtype, True, seed=5)
        got, want = ops.reduce3_batched(di, dg), ops.reduce3_batched_plain(di, dg)
        assert got.shape == (1, ops.n_tiles(4), 3) == (1, 1, 3), got.shape
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        dot, nl2, ng2 = want.sum(1).unbind(-1)
        beta = gompertz_beta(dot, nl2, ng2, 1.0).contiguous()
        ec = (0.8 * coeff_from_sums(dot, nl2, ng2, beta, 1.0)).contiguous()
        out = ops.update_batched(x, di, dg, beta, ec)
        assert torch.equal(out, ops.update_batched_plain(x, di, dg, beta, ec)), dtype
    print("scripts[K1/K2 at C=1, N=4]: equal to their plain versions, f32 and bf16", flush=True)


def scripts_run():
    """Phase 15's scripts, each on the card with the counters reset just
    before: ``torch_smoke_models`` (the 10 reduced archs: f32 K4 and K5 at
    D = 64, forward, loss and one decode step), ``torch_smoke_fl`` and the
    quickstart (K1/K2 at C = 1, N = 4).  Each asserts finiteness as its
    original does.  Returns {script: launches}."""
    import importlib.util

    check_tiny_update()
    out = {}
    for rel, k12 in SCRIPTS:
        t0 = time.perf_counter()
        spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_launches()
        mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        out[Path(rel).stem] = launches = all_launches()
        print(f"scripts[{rel}]: passed in {time.perf_counter() - t0:.1f}s; launches "
              f"{launches}", flush=True)
        if k12 is not None:
            assert launches["reduce3"] == launches["update"] == k12, (rel, launches)
        assert any(launches.values()), (rel, launches)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 16: the multi-device engines at one rank on NCCL, and the
# model-sharded update's tile ranges emulated rank by rank
MESH_LAYOUTS = [dict(backend="shard_map"), dict(backend="shard_map", output_sharding="sharded"),
                dict(backend="mesh", mesh="pods:1x1x1"),
                dict(backend="mesh", mesh="pods:1x1x1", output_sharding="sharded")]
MESH_M = (2, 4, 8)  # emulated model ranks
MESH_TIMED_M = (2, 4)
MESH_CASES = [  # (label, C, N, dtype, shared d_g)
    ("main", MAIN_C, MAIN_N, torch.float32, True),
    ("per-client d_g", MAIN_C, MAIN_N, torch.float32, False),
    ("bf16 ragged N", MAIN_C, 1_000_003, torch.bfloat16, True),
    ("C=1 (LM)", 1, LM_N, torch.float32, True),
]


def _emulated_update(x, di, dg, m, impl="auto"):
    """The model-sharded update of ``m`` ranks on one card: each rank's K1
    and K2 on its tile range in turn, the zero-padded partial buffers summed
    in rank order (what the all_reduce computes: disjoint supports) and the
    ranges written into one output (what the all_gather assembles)."""
    t = ops.n_tiles(x.shape[1])
    full = ops.reduce3_range(di, dg, m, 0, impl=impl)
    for s in range(1, m):
        full = full + ops.reduce3_range(di, dg, m, s, impl=impl)
    beta, ec = ops.scalars_from_partials(full[:, :t].contiguous(), 0.01, 1.0, 1.0, 1e-12)
    out = torch.empty_like(x)
    for s in range(m):
        ops.update_range(x, di, dg, beta, ec, out, m, s, impl=impl)
    return out, beta


def _range_views(x, di, dg, m, s):
    t0, t1, _ = ops.tile_range(x.shape[1], m, s)
    lo, hi = t0 * ops.TILE, min(t1 * ops.TILE, x.shape[1])
    return x[:, lo:hi], di[:, lo:hi], dg[..., lo:hi], t1 - t0


def mesh_update_run():
    """The tile-range K1/K2 at m in ``MESH_M`` emulated ranks on each case,
    bitwise against the whole-row pair (kernels) and the whole-row plain
    pair (plain versions); each range's K2 bitwise against its plain
    version on the same scalars and its K1 within K1's limit (another
    summation order); K1 = K2 = m launches a call.  Returns (the
    emulation's launch counts, the worst K1/K2 error against plain)."""
    counts = {"reduce3": 0, "update": 0}
    worst = {"reduce3": 0.0, "update": 0.0}
    for i, (label, c, n, dtype, shared) in enumerate(MESH_CASES):
        x, di, dg = make_operands(c, n, dtype, shared, seed=40 + i)
        saved = dict(ops.LAUNCHES)  # the comparison launches do not count
        want = ops.pfedsop_update_batched(x, di, dg, 0.01, 1.0, 1.0, impl="kernel")
        ops.LAUNCHES.update(saved)
        for m in MESH_M:
            before = dict(ops.LAUNCHES)
            got = _emulated_update(x, di, dg, m)
            made = {k: ops.LAUNCHES[k] - before[k] for k in before}
            assert made == {"reduce3": m, "update": m}, (label, m, made)
            for k in counts:
                counts[k] += made[k]
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (label, m)
            del got
            saved = dict(ops.LAUNCHES)
            plain = _emulated_update(x, di, dg, m, impl="plain")
            whole = ops.update_batched_plain(
                x, di, dg, *ops.scalars_from_partials(ops.reduce3_batched_plain(di, dg),
                                                      0.01, 1.0, 1.0, 1e-12))
            assert torch.equal(plain[0], whole), (label, m, "plain")
            del plain, whole
            for s in range(m):
                xs, ds, gs, tiles = _range_views(x, di, dg, m, s)
                if not tiles:
                    continue
                k1, p1 = ops.reduce3_batched(ds, gs), ops.reduce3_batched_plain(ds, gs)
                err1 = (k1 - p1).abs().max().item()
                assert err1 <= 1e-5 * p1.abs().max().item(), (label, m, s, err1)
                beta, ec = ops.scalars_from_partials(p1, 0.01, 1.0, 1.0, 1e-12)
                k2 = ops.update_batched(xs, ds, gs, beta, ec)
                assert torch.equal(k2, ops.update_batched_plain(xs, ds, gs, beta, ec)), \
                    (label, m, s)
                worst["reduce3"] = max(worst["reduce3"], err1)
                del k1, p1, k2
            ops.LAUNCHES.update(saved)
        print(f"mesh update[{label}]: C={c} N={n} {str(dtype)[6:]} shared={shared}: "
              f"m = {MESH_M} bitwise equal to the whole-row pair, kernel and plain; "
              f"K1 = K2 = m launches a call", flush=True)
        del x, di, dg, want
        torch.cuda.empty_cache()
    return counts, worst


def time_ranges():
    """Rank 0's K1 and K2 launch on its tile range at the ResNet path's
    shape, at ``MESH_TIMED_M`` model ranks, beside their bounds
    (``kernels/costs.py``) and the plain versions' times; phase 3 runs it
    (in phase 16, after phases 9-15's profiler sessions, torch.profiler saw
    no device event at all on the card).  Returns the range records'
    measured fields (m = 2's at the top, each m's under ``by_m``)."""
    x, di, dg = make_operands(MAIN_C, MAIN_N, torch.float32, True, seed=40)
    beta, ec = ops.scalars_from_partials(ops.reduce3_batched_plain(di, dg), 0.01, 1.0, 1.0,
                                         1e-12)
    out = torch.empty_like(x)
    rec = {"reduce3": {}, "update": {}}
    for m in MESH_TIMED_M:
        xs, ds, gs, tiles = _range_views(x, di, dg, m, 0)
        n_local = xs.shape[1]
        b1, by1 = roofline.bound_ms(roofline.reduce3_cost(MAIN_C, n_local, tiles, 4))
        b2, by2 = roofline.bound_ms(roofline.update_cost(MAIN_C, n_local, 4))
        ys = out[:, :n_local]
        r1 = dict(ms=device_ms(lambda: ops.reduce3_batched(ds, gs)),
                  plain_ms=device_ms(lambda: ops.reduce3_batched_plain(ds, gs)),
                  bound_ms=b1, bound_by=by1)
        r2 = dict(ms=device_ms(lambda: ops.update_batched(xs, ds, gs, beta, ec, ys)),
                  plain_ms=device_ms(lambda: ops.update_batched_plain(xs, ds, gs, beta, ec, ys)),
                  bound_ms=b2, bound_by=by2)
        for k, r in (("reduce3", r1), ("update", r2)):
            rec[k][m] = r
            print(f"kernels[time {k} tile range, rank 0 of m={m}]: C={MAIN_C} "
                  f"N_local={n_local} f32 kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"kernel at {100 * r['bound_ms'] / r['ms']:.1f}% of bound", flush=True)
    del x, di, dg, out
    torch.cuda.empty_cache()
    return {k: {**r[MESH_TIMED_M[0]], "by_m": {str(m): v for m, v in r.items()}}
            for k, r in rec.items()}


def mesh_run():
    """Phase 16: ``mesh_update_run``; then a one-rank NCCL group (file store
    under ``SCRATCH``), the ``clients:1`` and ``pods:1x1x1`` meshes,
    ``nccl_reduce_scatter_check``, and the
    ResNet slice's pfedsop and fedavg for 3 rounds on every layout of
    ``MESH_LAYOUTS``, each history, broadcast and client rows bitwise the
    vmap run's.  Returns (path launch counts, the ranges' worst errors)."""
    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    emulated, worst = mesh_update_run()
    SCRATCH.mkdir(parents=True, exist_ok=True)
    store = SCRATCH / "nccl_store"
    store.unlink(missing_ok=True)
    collectives.init_world("cuda", store_path=str(store))
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        for text in ("clients:1", "pods:1x1x1"):
            mesh = mesh_lib.resolve_mesh(mesh_lib.parse_mesh(text))
            print(f"mesh[{text}]: {mesh}", flush=True)
        nccl_reduce_scatter_check()
        torch.backends.cudnn.deterministic = True
        counts = {"reduce3": 0, "update": 0}
        for name in ("pfedsop", "fedavg"):
            ref = resnet_driver(method(name), 3)
            h_ref = ref.run()
            for kw in MESH_LAYOUTS:
                reset_launches()
                collectives.reset_census()
                fed = resnet_driver(method(name), 3, **kw)
                h = fed.run()
                for k in counts:
                    counts[k] += ops.LAUNCHES[k]
                for key in ("loss", "acc", "sim_time", "mean_best_acc"):
                    assert h[key] == h_ref[key], (name, kw, key, h[key], h_ref[key])
                assert _same_tensors(fed.broadcast, ref.broadcast), (name, kw)
                assert _same_tensors(fed.client_states, ref.client_states), (name, kw)
                census = collectives.census()
                assert census["all-gather"]["count"] > 0, census
                print(f"mesh[{name} {kw}]: bitwise equal to vmap; round_time "
                      f"{[round(t, 4) for t in h['round_time']]} s (vmap "
                      f"{[round(t, 4) for t in h_ref['round_time']]} s); census {census}",
                      flush=True)
                del fed
            del ref
        want = {"reduce3": 3 * len(MESH_LAYOUTS), "update": 3 * len(MESH_LAYOUTS)}
        assert counts == want, (counts, want)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(SCRATCH, ignore_errors=True)
    print(f"mesh: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    emulated.update(reduce3_range=emulated["reduce3"], update_range=emulated["update"])
    return {"resnet9_mesh": counts, "mesh_update_ranges": emulated}, worst


def nccl_reduce_scatter_check():
    """``collectives.reduce_scatter``'s NCCL branch (``movedim``,
    ``reduce_scatter_tensor``, ``movedim`` back), which phase 20's gloo
    ranks never take, in phase 16's one-rank NCCL group: on phase 20's
    embedding partial (batch 4, 1,024 positions, 1,152 wide, bf16) and a
    transposed view of it, along each dim, bitwise the all-reduce then the
    slice, contiguous, one census entry of the result's bytes a call."""
    import torch.distributed as dist

    from repro_torch.launch import collectives

    g = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(4, TP_SERVE["prompt"], 1152, generator=g, device="cuda").to(torch.bfloat16)
    n = dist.get_world_size()
    for src in (x, x.transpose(0, 1)):
        for dim in range(src.dim()):
            collectives.reset_census()
            got = collectives.reduce_scatter(src, None, dim)
            census = collectives.census()
            whole = src.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(whole)
            w = src.shape[dim] // n
            want = whole.narrow(dim, dist.get_rank() * w, w)
            assert torch.equal(got, want) and got.is_contiguous(), (tuple(src.shape), dim)
            assert census == {"reduce-scatter": {"bytes": got.nbytes, "count": 1}}, census
    collectives.reset_census()
    print(f"mesh: reduce_scatter on NCCL ({n} rank) bitwise the all-reduce then the slice, "
          f"{tuple(x.shape)} and its transpose along each dim", flush=True)


# phase 17: the LM train step on a mesh engine, and launch/train.py's loop
MESH_TRAIN_CHUNKS = (1, 2)
TRAIN_ROUNDS = 3
SPLIT_JOIN_S = 150  # the two data ranks' answers, then they are killed


def tree_digest(tree):
    """Per leaf, the position-weighted sum of its bit patterns (int64,
    wrapping, on the card): equal trees give equal digests, and a changed
    bit changes its leaf's."""
    out = []
    for x in tree_leaves(tree):
        bits = x.contiguous().view({2: torch.int16, 4: torch.int32}[x.element_size()]).reshape(-1)
        total = 0
        for lo in range(0, bits.numel(), 1 << 26):
            part = bits[lo:lo + (1 << 26)].long()
            w = (torch.arange(lo, lo + part.numel(), device=part.device) % 65521) + 1
            total += int((part * w).sum())
        out.append(total)
    return out


def _split_rank(rank, port, answers):
    """One of two processes on the one card, a gloo group (NCCL refuses a
    second rank on a device): phase 17's step on ``pods:1x2x1`` at
    ``grad_chunks`` 2, each rank one sequence of every batch."""
    import datetime
    import traceback

    import torch.distributed as dist

    from repro_torch.fl.engine import MeshBackend
    from repro_torch.kernels.dispatch import grad_chunk_count
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import parse_mesh

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=60))
        try:
            cfg = get_config("gemma3-1b")
            args = launch_step_args(cfg)
            engine = MeshBackend(1, parse_mesh("pods:1x2x1"), data_chunks=2)
            step = lm_steps.make_train_step(cfg, LAUNCH_SHAPE, PFedSOPConfig(
                eta1=0.1, eta2=0.1, rho=1.0, lam=1.0), engine=engine)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            collectives.reset_census()
            reset_launches()
            t0 = time.perf_counter()
            with grad_chunk_count(2):
                out = step(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            answers.put((rank, True, dict(
                digest=tree_digest(out), wall=wall, launches=all_launches(),
                census=collectives.census(), data_split=engine.data_split,
                peak=torch.cuda.max_memory_allocated())))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent fails the phase with this traceback
        answers.put((rank, False, traceback.format_exc()))


def split_on_one_card(want):
    """``_split_rank`` on 2 processes; each rank's result must have the
    digest ``want`` (the in-body 2-chunk step's).  Returns rank 0's answer."""
    got = _spawn_two(_split_rank, (), SPLIT_JOIN_S)
    for rank, r in sorted(got.items()):
        print(f"mesh train[pods:1x2x1 data split, 2 processes on one card, gloo, rank {rank}]: "
              f"bitwise the in-body 2-chunk step: {r['digest'] == want}; data split "
              f"{r['data_split']}; wall {1e3 * r['wall']:.3f} ms; peak device memory "
              f"{r['peak']} bytes ({r['peak'] / 2**30:.3f} GiB); census {r['census']}; "
              f"launches {r['launches']}", flush=True)
        assert r["digest"] == want and r["data_split"] is True, rank
    return got[0]


def mesh_train_run():
    """Phase 17, at world 1 on NCCL (a one-rank group, file store under
    ``SCRATCH``): ``make_train_step`` at phase 15's shape (gemma3-1b, one
    client, B = 2, S = 2048, T = 2) through ``MeshBackend(1, pods:1x1x1)``,
    bit for bit the engine-less step, at ``grad_chunks`` 1 and 2, with the
    launch counters reset just before the engine step and its launches
    asserted (the per-step launches times the chunks, one K1/K2 pair), its
    peak device memory (below the card's 80 GB; at 2 chunks beside the dry
    run's prediction) and wall; the same 2-chunk step on ``pods:1x2x1`` in
    two processes sharing the card over gloo (``split_on_one_card``: the
    data split, each rank one chunk), bitwise by digest; then
    ``launch/train.py``'s round loop
    (``train.run``) at gemma3-1b's full width, ``TRAIN_ROUNDS`` rounds,
    replicated and sharded, with equal losses.  Returns {path: launches}."""
    import torch.distributed as dist

    from repro_torch.fl.engine import MeshBackend
    from repro_torch.kernels.dispatch import grad_chunk_count
    from repro_torch.launch import collectives
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import parse_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0)
    with grad_chunk_count(2):
        rec = dryrun.run_one("gemma3-1b", LAUNCH_SHAPE, micro_batch=LM["batch"], save=False,
                             verbose=False)
    predicted2 = (rec["memory_analysis"]["argument_size_in_bytes"]
                  + rec["memory_analysis"]["temp_size_in_bytes"])
    per_step = lm_driver.launches_per_step(cfg)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    store = SCRATCH / "nccl_store"
    store.unlink(missing_ok=True)
    collectives.init_world("cuda", store_path=str(store))
    paths = {}
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        engine = MeshBackend(1, parse_mesh("pods:1x1x1"))
        base = torch.cuda.memory_allocated()
        args = launch_step_args(cfg)
        plain = lm_steps.make_train_step(cfg, LAUNCH_SHAPE, pcfg)
        meshed = lm_steps.make_train_step(cfg, LAUNCH_SHAPE, pcfg, engine=engine)
        for n in MESH_TRAIN_CHUNKS:
            with grad_chunk_count(n):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                collectives.reset_census()
                reset_launches()
                t0 = time.perf_counter()
                got = meshed(*args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = all_launches()
                peak = torch.cuda.max_memory_allocated() - base
                want = plain(*args)
            same = _same_tensors(got, want)
            loss = got[2].item()
            pred = (f"; the dry run predicted {predicted2} bytes ({predicted2 / 2**30:.3f} "
                    f"GiB): {100 * (predicted2 - peak) / peak:+.2f}%" if n == 2 else "")
            print(f"mesh train[pods:1x1x1, grad_chunks={n}]: bitwise the engine-less step: "
                  f"{same}; loss {loss:.6f}; wall {1e3 * wall:.3f} ms; peak device memory "
                  f"{peak} bytes ({peak / 2**30:.3f} GiB){pred}; data split "
                  f"{engine.data_split}; census {collectives.census()}; launches {launches}",
                  flush=True)
            assert same and math.isfinite(loss), (n, loss)
            assert peak < roofline.HBM_CAPACITY, peak
            expect = {**{k: 0 for k in launches}, "reduce3": 1, "update": 1,
                      **{k: v * n * LM["local_iters"] for k, v in per_step.items()}}
            assert launches == expect, (launches, expect)
            paths[f"mesh_train_step_gemma3_1b_chunks{n}"] = launches
            digest = tree_digest(got)
            del got, want
        del args, plain, meshed
        gc.collect()
        torch.cuda.empty_cache()
        split = split_on_one_card(digest)
        expect = {**{k: 0 for k in split["launches"]}, "reduce3": 1, "update": 1,
                  **{k: v * LM["local_iters"] for k, v in per_step.items()}}
        assert split["launches"] == expect, (split["launches"], expect)
        paths["mesh_train_step_gemma3_1b_data_split_rank0"] = split["launches"]

        losses = {}
        for out in ("replicated", "sharded"):
            reset_launches()
            t0 = time.perf_counter()
            hist, final = train_cli.run(cfg, rounds=TRAIN_ROUNDS, local_iters=LM["local_iters"],
                                        micro_batch=LM["batch"], seq_len=LM["seq_len"], seed=0,
                                        output_sharding=out, device="cuda")
            torch.cuda.synchronize()
            launches = all_launches()
            losses[out] = hist["loss"]
            print(f"mesh train[launch/train.py, {out}]: {TRAIN_ROUNDS} rounds in "
                  f"{time.perf_counter() - t0:.1f}s: loss {hist['loss']}, round_time "
                  f"{[round(t, 4) for t in hist['round_time']]} s; launches {launches}",
                  flush=True)
            assert all(math.isfinite(v) for v in hist["loss"]), hist["loss"]
            assert launches["reduce3"] == launches["update"] == TRAIN_ROUNDS, launches
            paths[f"train_py_gemma3_1b_{out}"] = launches
            del final
            gc.collect()
            torch.cuda.empty_cache()
        assert losses["replicated"] == losses["sharded"], losses
    finally:
        dist.destroy_process_group()
        shutil.rmtree(SCRATCH, ignore_errors=True)
    print(f"mesh train: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return paths


# phase 18: tensor-parallel serving over two processes sharing the card
TP_SERVE = dict(batch=4, prompt=1024, steps=16, capacity=1088, mesh="pods:1x1x2")  # phase 12's
TP_ARCHS = ("gemma3-1b", "granite-moe-1b-a400m", "zamba2-2.7b", "internvl2-2b",
            "musicgen-large")
TP_JOIN_S = 600  # both ranks' answers for every arch, then they are killed
TP_PEAK_RTOL = 0.10  # each rank's step peak against the dry run's
TP_ATOL = 5e-3  # rtol = atol: test_torch_serve.py's bound
# each arch's limit on |d| / (TP_ATOL + TP_ATOL |want|) against the whole
# model: at full depth in bf16 a sound reordering of the sums reads far
# above the bare bound (1); on an H100 the sound runs read 7.451 (gemma3-1b;
# its reference path 7.63), 17.92, 13.31, 8.058 and 6.462 (PERF.md, section
# 6), and each limit is 1.34x its reading
TP_LIMIT = {"gemma3-1b": 10.0, "granite-moe-1b-a400m": 24.0, "zamba2-2.7b": 18.0,
            "internvl2-2b": 11.0, "musicgen-large": 8.7}
# the planted faults: name -> (its arch, the most decode steps served after
# the prefill under the fault); each must read above its arch's limit or
# change a greedy token of the sound run's same steps, and is served only
# until it does (the verdict is the one all its steps would give).  A fault
# in prefill shows at once; a decode fault that drops or mis-weights the new
# token's slot (one of ~1,000 a head under random weights) is served every
# step.  The codebook embeddings summed on each rank before one all-reduce
# are a reordering of the same additions (on the CPU in f32 they hold
# 1e-5), so the codebook fault is the lookup without the rank's vocab
# offset.
TP_FAULTS = {"row_all_reduce_dropped": ("gemma3-1b", 0),
             "owner_write_skipped": ("gemma3-1b", TP_SERVE["steps"]),
             "combine_unscaled": ("gemma3-1b", TP_SERVE["steps"]),
             "argmax_offset_dropped": ("gemma3-1b", TP_SERVE["steps"]),
             "moe_sum_dropped": ("granite-moe-1b-a400m", 2),
             "ssm_norm_rank_local": ("zamba2-2.7b", 2),
             "ssm_gather_reversed": ("zamba2-2.7b", 2),
             "int8_write_without_scale": ("musicgen-large", TP_SERVE["steps"]),
             "codebook_offset_dropped": ("musicgen-large", 2)}


def depth_cut(arch, n_rep):
    """``arch``'s full config with ``n_rep`` pattern repetitions (None: its
    full depth)."""
    cfg = get_config(arch)
    if n_rep is None:
        return cfg
    return cfg.replace(n_rep=n_rep, n_layers=n_rep * len(cfg.pattern) + len(cfg.tail))


def _tp_shapes():
    """(prefill, decode) ``InputShape``s of phase 18's serving steps."""
    b, cap = TP_SERVE["batch"], TP_SERVE["capacity"]
    return (InputShape("tp_prefill", TP_SERVE["prompt"], b, "prefill"),
            InputShape("tp_decode", cap, b, "decode"))


def _storage_bytes(tree):
    seen = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)}
    return sum(seen.values())


def _step_peak(fn, args):
    """(result, census, peak bytes): ``fn(*args)`` with the census reset
    before it; the peak is the arguments' bytes plus what the call
    allocated beyond what was live before it (``max_memory_allocated``),
    as the dry run counts argument + temp."""
    from repro_torch.launch import collectives

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_census()
    out = fn(*args)
    torch.cuda.synchronize()
    census = collectives.census()
    return out, census, _storage_bytes(args) + torch.cuda.max_memory_allocated() - base


def _host(x):
    """``x`` as a numpy array (bf16 widened to f32, exactly): the answers
    cross the process boundary by value, not as shared-memory tensors
    whose handles die with the rank."""
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _tp_prompt(cfg):
    """Phase 18's prompt of ``cfg`` on the card, from seed 0: tokens (and
    the vision arch's patch embeddings) in ``steps.token_batch``'s layout,
    phase 12's batch and length."""
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = {}
    for name, (shape, dtype) in lm_steps.token_batch(cfg, TP_SERVE["batch"],
                                                     TP_SERVE["prompt"]).items():
        if name == "tokens":
            prompt[name] = torch.randint(0, cfg.vocab_size, shape, generator=g, device="cuda")
        elif name == "patch_embeds":
            prompt[name] = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    return prompt


def _tp_step_batch(cfg, tokens):
    """A decode batch from the next tokens (``steps.next_tokens``'s
    layout): the vision arch's holds 0 patches."""
    batch = {"tokens": tokens}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.zeros((tokens.shape[0], 0, cfg.d_vision),
                                            device=tokens.device)
    return batch


def _combine_unscaled(m, l, o, tp):
    """A planted fault: ``parallel.combine_attention`` with each rank's part
    weighted 1 where it must be weighted ``exp(m_r - M)``."""
    from repro_torch.models import parallel

    parts = parallel.gather(torch.cat([l, o], dim=-1).unsqueeze(0), tp, 0)
    return parts[..., 1:].sum(0) / parts[..., :1].sum(0)


def _gather_reversed(x, tp):
    """A planted fault: the SSM conv output gathered over its channels in
    the reverse rank order."""
    from repro_torch.models import parallel

    return torch.cat(parallel.gather(x, tp, -1).chunk(tp.size, -1)[::-1], dim=-1)


def _owner_write_without_scale(cache, name, slot, new, lo=None):
    """A planted fault: ``attention._store_token`` writing an int8 cache's
    quantised values but not their scales."""
    from repro_torch.models import attention

    qv, _ = attention._quantize(new)
    if lo is None:
        attention._write_slot(cache[name], slot, qv)
    else:
        attention._write_owned(cache[name], slot, qv, lo)


def _plants():
    """``TP_FAULTS``' replacements: name -> (module, attribute, fault)."""
    import dataclasses

    from repro_torch.models import attention, parallel, ssm

    argmax, embed = parallel.vocab_argmax, parallel.vocab_embed
    return {
        "row_all_reduce_dropped": (parallel, "row",
                                   lambda eq, x, w, tp: torch.einsum(eq, x, w)),
        "owner_write_skipped": (attention, "_write_owned", lambda buf, slot, value, lo: None),
        "combine_unscaled": (parallel, "combine_attention", _combine_unscaled),
        # each rank taking itself for rank 0: no slice offset
        "argmax_offset_dropped": (parallel, "vocab_argmax", lambda logits, tp, vocab: argmax(
            logits, dataclasses.replace(tp, rank=0), vocab)),
        "moe_sum_dropped": (parallel, "sum_f32", lambda x, tp: x),
        "ssm_norm_rank_local": (parallel, "rms_noscale",
                                lambda x, tp, whole, eps=1e-6: ssm.rmsnorm_noscale(x, eps)),
        "ssm_gather_reversed": (ssm, "_gather_channels", _gather_reversed),
        "int8_write_without_scale": (attention, "_store_token", _owner_write_without_scale),
        "codebook_offset_dropped": (parallel, "vocab_embed", lambda tokens, emb, tp, vocab: embed(
            tokens, emb, dataclasses.replace(tp, rank=0), vocab)),
    }


# phase 20: the sequence-parallel prefill (the seqshard variant), run by
# phase 18's two processes on the same prompt, against the whole model's
# logits on the same params, in phase 18's units.  name -> (arch, the MoE
# impl: None for the config's); the capacity dispatches reuse granite-moe's
# params at SEQ_CAPACITY, which drops slots
SEQ_CASES = {"gemma3-1b": ("gemma3-1b", None),
             "granite-moe-1b-a400m": ("granite-moe-1b-a400m", None),
             "granite-moe-1b-a400m/dispatch": ("granite-moe-1b-a400m", "dispatch"),
             "granite-moe-1b-a400m/dispatch_grouped": ("granite-moe-1b-a400m",
                                                       "dispatch_grouped"),
             "zamba2-2.7b": ("zamba2-2.7b", None),
             "internvl2-2b": ("internvl2-2b", None),
             "musicgen-large": ("musicgen-large", None)}
SEQ_CAPACITY = 0.5
# each case's limit on |d| / (TP_ATOL + TP_ATOL |want|) of the last-token
# logits against the whole model: 1.34x its first sound reading on an H100
# (PERF.md, section 6): granite-moe's 9.045 (its dense MoE's bf16 sums on
# 2,048 rows), musicgen's 7.466 (the codebook partials summed before the
# scatter), the dispatches' 14.08 and 2.309 (a router bit that flips one
# slot's expert moves every later slot of that expert, and which slots
# the capacity drops).  gemma3-1b, zamba2 and internvl2 read 0 (the whole
# model's bits), and 1.34x of it would ask for bits, so their limit is the
# bare bound, 1 (rtol = atol = 5e-3), under their faults' least readings
# (12.68, 9.884, 6,297)
SEQ_LIMIT = {"gemma3-1b": 1.0, "granite-moe-1b-a400m": 12.2,
             "granite-moe-1b-a400m/dispatch": 18.9,
             "granite-moe-1b-a400m/dispatch_grouped": 3.1,
             "zamba2-2.7b": 1.0, "internvl2-2b": 1.0, "musicgen-large": 10.0}
SEQ_PEAK_RTOL = 0.03  # each rank's prefill peak against the dry run's


def _seq_plants():
    """The planted faults (``scripts/seqshard_faults.py``, which the CPU
    tests also plant): (name -> (module, attribute, fault), name -> the
    case it is read on)."""
    import seqshard_faults

    return seqshard_faults.faults(), seqshard_faults.ARCH


def _seq_cfg(name):
    arch, impl = SEQ_CASES[name]
    cfg = get_config(arch).replace(seq_shard=True)
    return cfg if impl is None else cfg.replace(moe_impl=impl, capacity_factor=SEQ_CAPACITY)


def _seq_whole(names):
    """The whole model's last-token logits of each case of ``names`` whose
    MoE impl is not its config's (the others are phase 18's prefill), on
    the card (seed 0, phase 18's prompt)."""
    out = {}
    for name in names:
        arch, impl = SEQ_CASES[name]
        if impl is None:
            continue
        cfg = _seq_cfg(name).replace(seq_shard=False)
        params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                device="cuda")
        out[name] = lm_steps.make_prefill_step(cfg, _tp_shapes()[0])(params,
                                                                     _tp_prompt(cfg)).cpu()
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _seq_rank(name, params, prompt, tp, want):
    """Phase 20 on this rank: case ``name``'s sequence-parallel prefill
    step (``make_prefill_step`` with ``seq_shard``; ``params`` cut by
    ``rank_plan(seqshard=True)``) on phase 18's prompt, the launch counters
    reset just before (timed), once more under the profiler (wall and
    device busy), once alone for its census and peak; then each planted
    fault read on the case for one prefill, its reading against ``want``
    (the whole model's last-token logits)."""
    cfg = _seq_cfg(name)
    step = lm_steps.make_prefill_step(cfg, _tp_shapes()[0], tp)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits = step(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = all_launches()

    def again():
        t1 = time.perf_counter()
        step(params, prompt)
        return None, time.perf_counter() - t1

    _, wall_p, busy_us = profiled_run(again)
    _, census, peak = _step_peak(step, (params, prompt))
    faulty = {}
    plants, cases = _seq_plants()
    for fault, (module, attr, replacement) in plants.items():
        if cases[fault] != name:
            continue
        sound = getattr(module, attr)
        setattr(module, attr, replacement)
        try:
            faulty[fault] = _tp_gap(_host(step(params, prompt)), want)[0]
        finally:
            setattr(module, attr, sound)
    return dict(logits=_host(logits), prefill_s=prefill_s, wall_p=wall_p, busy_us=busy_us,
                launches=launches, census=census, peak=peak, faulty=faulty)


def _tp_rank(rank, port, answers, teachers, want, seq_want):
    """One of two processes on the one card (gloo: NCCL refuses a second
    rank on a device), ``pods:1x1x2``, for each arch of ``teachers`` (arch
    -> the whole model's next tokens, step by step): its model slices
    (seed 0), the prompt served by ``prefill_with_caches`` and
    ``TP_SERVE["steps"]`` decode steps teacher-forced, the launch counters
    reset just before (the last 4 steps profiled); each step's logits
    gathered over the vocab and its greedy tokens by
    ``parallel.vocab_argmax``; the prefill and serve steps alone, each with
    its census and peak; then each planted fault of the arch, patched in
    for a prefill and its decode steps (``TP_FAULTS``) until ``want`` (arch
    -> the whole model's logits, step by step) shows it caught, with the
    greedy tokens it changes.  For each case of ``SEQ_CASES`` on the arch,
    phase 20 (``_seq_rank``) on its sequence-parallel slices against
    ``seq_want`` (case -> the whole model's last-token logits)."""
    import datetime
    import traceback

    import torch.distributed as dist

    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.models import parallel
    from repro_torch.weights import cut

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=120))
        try:
            tp = lm_steps.tensor_parallel(parse_mesh(TP_SERVE["mesh"]))
            s, cap, steps = TP_SERVE["prompt"], TP_SERVE["capacity"], TP_SERVE["steps"]
            shape_p, shape_d = _tp_shapes()
            plants = _plants()
            out = {}
            for arch, teacher in teachers.items():
                marks = [time.perf_counter()]  # the seconds of each part, below
                cfg = get_config(arch)
                whole = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                       device="cuda")
                params = cut(whole, rank_plan(whole, "params", 1, tp.size, 0, tp.rank))
                seq_names = [n for n, (a, _) in SEQ_CASES.items() if a == arch]
                seq_params = (cut(whole, rank_plan(whole, "params", 1, tp.size, 0, tp.rank,
                                                   seqshard=True))
                              if seq_names else None)
                del whole
                gc.collect()
                torch.cuda.empty_cache()
                prompt = _tp_prompt(cfg)
                teacher = teacher.cuda()
                pos = torch.zeros((), dtype=torch.int32, device="cuda")
                (torch.ones(64, 64, device="cuda") @ torch.ones(64, 64, device="cuda")).sum().item()

                def vocab(x):
                    return parallel.gather(x, tp, -1) if x.shape[-1] != cfg.vocab_size else x

                def decode(t, caches):
                    pos.fill_(s + t)
                    return tf.decode_step(params, cfg, _tp_step_batch(cfg, teacher[t]), pos,
                                          caches, tp=tp)

                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                logits, caches = tf.prefill_with_caches(params, cfg, prompt, capacity=cap, tp=tp)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
                local, step_s = [logits], []

                def step(t):
                    nonlocal caches
                    t1 = time.perf_counter()
                    out_t, caches = decode(t, caches)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t1)
                    local.append(out_t)

                profiled = 4
                for t in range(steps - profiled):
                    step(t)

                def last_steps():
                    t1 = time.perf_counter()
                    for t in range(steps - profiled, steps):
                        step(t)
                    return None, time.perf_counter() - t1

                _, wall_p, busy_us = profiled_run(last_steps)
                launches = all_launches()
                outs = [_host(vocab(x)) for x in local]
                tokens = [_host(parallel.vocab_argmax(x, tp, cfg.vocab_size)) for x in local]

                marks.append(time.perf_counter())
                # the two steps alone, as the dry run counts them
                _, census_p, peak_p = _step_peak(lm_steps.make_prefill_step(cfg, shape_p, tp),
                                                 (params, prompt))
                pos.fill_(s + steps)
                (tok, _), census_d, peak_d = _step_peak(
                    lm_steps.make_serve_step(cfg, shape_d, tp),
                    (params, _tp_step_batch(cfg, teacher[steps]), pos, caches))
                del caches, local, logits
                gc.collect()
                torch.cuda.empty_cache()
                marks.append(time.perf_counter())

                # name -> (logits, greedy tokens changed from the sound run's): the
                # prefill, then one decode step at a time until the fault is caught
                # (above the limit or a token changed) or its steps are served; both
                # ranks stop together on the MAX of their verdicts
                faulty = {}
                for name, (_, n_steps) in ((n, f) for n, f in TP_FAULTS.items()
                                           if f[0] == arch):
                    module, attr, fault = plants[name]
                    sound = getattr(module, attr)
                    setattr(module, attr, fault)
                    try:
                        kept, changed = [], 0
                        out_t, fc = tf.prefill_with_caches(params, cfg, prompt, capacity=cap,
                                                           tp=tp)
                        for t in range(n_steps + 1):
                            if t:
                                out_t, fc = decode(t - 1, fc)
                            kept.append(_host(vocab(out_t)))
                            changed += int((_host(parallel.vocab_argmax(
                                out_t, tp, cfg.vocab_size)) != tokens[t]).sum())
                            caught = torch.tensor([int(
                                _tp_gap(kept[-1], want[arch][t])[0] > TP_LIMIT[arch]
                                or changed > 0)])
                            dist.all_reduce(caught, op=dist.ReduceOp.MAX)
                            if caught.item():
                                break
                        faulty[name] = (kept, changed)
                        del fc, out_t
                    finally:
                        setattr(module, attr, sound)
                marks.append(time.perf_counter())
                seq = {}
                if seq_params is not None:  # phase 20
                    for name in seq_names:
                        seq[name] = _seq_rank(name, seq_params, prompt, tp, seq_want[name])
                    del seq_params
                    gc.collect()
                    torch.cuda.empty_cache()
                marks.append(time.perf_counter())
                out[arch] = dict(
                    logits=outs, tokens=tokens, faulty=faulty, prefill_s=prefill_s,
                    step_s=step_s, wall_p=wall_p, busy_us=busy_us, launches=launches,
                    census_p=census_p, census_d=census_d, peak_p=peak_p, peak_d=peak_d,
                    token=_host(tok), parts=np.diff(marks).tolist(), seq=seq)
                del params, prompt
                gc.collect()
                torch.cuda.empty_cache()
            answers.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent fails the phase with this traceback
        answers.put((rank, False, traceback.format_exc()))


def _with_inputs(target, rank, port, answers, inbox, *args):
    """A rank of ``_spawn_two`` with ``prepare``: it reaches the card, waits
    for the parent's inputs, then runs ``target`` with them after
    ``args``."""
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
        torch.zeros((), device="cuda")  # the CUDA context, while the parent prepares
    target(rank, port, answers, *args, *inbox.get())


def _spawn_two(target, args, join_s, prepare=None):
    """``target(rank, port, answers, *args)`` in 2 spawned processes; each
    rank's answer, or the phase fails with a rank's traceback.  With
    ``prepare``, the ranks start first and ``prepare()`` runs here while
    they import and reach the card; its result (a tuple) is sent to each
    rank and appended to its arguments.  ``join_s`` counts from then."""
    import multiprocessing as mp
    import queue
    import socket

    ctx = mp.get_context("spawn")
    answers = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if prepare is None:
        procs = [ctx.Process(target=target, args=(r, port, answers, *args), daemon=True)
                 for r in range(2)]
    else:
        inboxes = [ctx.Queue() for _ in range(2)]
        procs = [ctx.Process(target=_with_inputs, args=(target, r, port, answers, inboxes[r],
                                                        *args), daemon=True)
                 for r in range(2)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic()
    try:
        if prepare is not None:
            inputs = prepare()
            for box in inboxes:
                box.put(inputs)
        deadline = time.monotonic() + join_s
        while len(got) < 2 and time.monotonic() < deadline:
            try:
                rank, ok, value = answers.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            assert ok, f"rank {rank}:\n{value}"
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    assert len(got) == 2, (f"ranks answered {sorted(got)} of 2 within {join_s} s; "
                           f"exit codes {[p.exitcode for p in procs]}")
    return got


def _tp_gap(got, want):
    """(worst |got - want| over 5e-3 + 5e-3 |want| (at most 1: within
    test_torch_serve.py's rtol = atol = 5e-3), the error in units of the
    largest |want|)."""
    got, want = torch.as_tensor(got).float().cpu(), want.float().cpu()
    ratio = ((got - want).abs() / (TP_ATOL + TP_ATOL * want.abs())).max().item()
    return ratio, errors(got, want)[1]


def _tp_whole(arch):
    """``arch``'s whole model at full width on the card (seed 0): the
    logits of the prompt and of ``TP_SERVE["steps"]`` greedy decode steps
    (on the host), the next tokens fed at each step, and the gaps of the
    reference path teacher-forced on them (the bf16 floor of two sound
    paths, printed beside the reading)."""
    cfg = get_config(arch)
    s, cap = TP_SERVE["prompt"], TP_SERVE["capacity"]
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompt = _tp_prompt(cfg)
    floor = []
    for run_cfg in (cfg, cfg.replace(kernel_impl="reference")):
        logits, caches = tf.prefill_with_caches(params, run_cfg, prompt, capacity=cap)
        outs = [logits]
        if run_cfg is cfg:
            feed = [lm_steps.next_tokens(cfg, logits.argmax(-1))]
        for t in range(TP_SERVE["steps"]):
            out, caches = tf.decode_step(params, run_cfg, _tp_step_batch(cfg, feed[t]), s + t,
                                         caches)
            outs.append(out)
            if run_cfg is cfg:
                feed.append(lm_steps.next_tokens(cfg, out.argmax(-1)))
        if run_cfg is cfg:
            want = [x.cpu() for x in outs]
        else:
            floor = [_tp_gap(x, w) for x, w in zip(outs, want)]
    del params, caches, logits, out, outs
    gc.collect()
    torch.cuda.empty_cache()
    return want, torch.stack(feed).cpu(), floor


def tp_serve_run():
    """Phase 18: each arch of ``TP_ARCHS`` at full width and depth in bf16
    served tensor-parallel on ``pods:1x1x2`` by two processes sharing the
    card (gloo, host-staged: no NVLink; one spawn for every arch), against
    its whole-model run on the same params, prompt (batch 4, 1,024
    positions; internvl2's 256 of them patches) and tokens, capacity
    1,088, ``TP_SERVE["steps"]`` decode steps teacher-forced on the whole
    model's greedy tokens.  For each arch and rank: the census of the
    prefill and serve steps equal to the dry run's count of the same shapes
    on a 2-rank fake world, the peaks within ``TP_PEAK_RTOL`` of the dry
    run's, the logits within the arch's ``TP_LIMIT`` of the whole model's,
    the greedy tokens the first argmax of their logits, rank 0's K4/K5
    launches those the config predicts (``serve_launches``); every planted
    fault of ``TP_FAULTS`` above its arch's limit or changing a greedy token
    from the sound run's.

    Phase 20 on the same ranks, for each case of ``SEQ_CASES``: the
    sequence-parallel prefill step's census equal to the dry run's
    ``seqshard`` count of the same shape on a 2-rank fake world, its peak
    within ``SEQ_PEAK_RTOL`` of the count's, its K4/K5 launches the
    count's, its last-token logits within ``SEQ_LIMIT`` of the whole
    model's, every planted fault read on the case
    (``scripts/seqshard_faults.py``'s ``ARCH``) above that limit; prefill
    ms and idle share beside phase 18's prefill of the same prompt.
    Returns rank 0's launches per arch of phase 18 and, under "seqshard
    <case>", of phase 20."""
    from repro_torch.launch.mesh import parse_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    wants, teachers, floors, counted = {}, {}, {}, {}
    seq_wants = {}

    def prepare():  # while the ranks start
        nonlocal t_spawn
        for arch in TP_ARCHS:
            wants[arch], teachers[arch], floors[arch] = _tp_whole(arch)
        seq_wants.update(_seq_whole(SEQ_CASES))
        for name, (arch, impl) in SEQ_CASES.items():
            if impl is None:
                seq_wants[name] = wants[arch][0]
        spec = parse_mesh(TP_SERVE["mesh"])
        for arch in TP_ARCHS:
            for shape in _tp_shapes():
                rec = dryrun.run_one(arch, shape, save=False, verbose=False, mesh=spec)
                assert rec["serve_layout"] == "tensor_parallel", rec["serve_layout"]
                counted[arch, shape.kind] = rec
        for name, (arch, _) in SEQ_CASES.items():
            rec = dryrun.run_one(arch, _tp_shapes()[0], save=False, verbose=False, mesh=spec,
                                 variant="seqshard", cfg=_seq_cfg(name))
            assert rec["serve_layout"] == "sequence_parallel", rec["serve_layout"]
            counted[name, "seqshard"] = rec
        t_spawn = time.perf_counter()
        return teachers, wants, seq_wants

    t_spawn = None
    got = _spawn_two(_tp_rank, (), TP_JOIN_S, prepare)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    b, steps = TP_SERVE["batch"], TP_SERVE["steps"]
    checks = []
    for arch in TP_ARCHS:
        want, limit, floor = wants[arch], TP_LIMIT[arch], floors[arch]
        for rank in sorted(got):
            r = got[rank][arch]
            gaps = [_tp_gap(x, w) for x, w in zip(r["logits"], want)]
            wrong = sum(int((tk != lg.argmax(-1)).sum()) for tk, lg in zip(r["tokens"],
                                                                           r["logits"]))
            agree = sum(int((tk == w.argmax(-1).numpy()).sum()) for tk, w in zip(r["tokens"],
                                                                                 want))
            # each fault: (its reading, greedy tokens changed from the sound run's,
            # the decode steps served until it was caught)
            faults = {name: (max(_tp_gap(x, w)[0] for x, w in zip(lg, want)), changed,
                             len(lg) - 1) for name, (lg, changed) in r["faulty"].items()}
            checks.append((arch, rank, r, gaps, wrong, faults))
            decode_ms = 1e3 * sum(r["step_s"]) / len(r["step_s"])
            print(f"tp serve[{arch}, {TP_SERVE['mesh']}, rank {rank}, gloo host-staged, 2 "
                  f"processes on one card, {smi}]: prefill {1e3 * r['prefill_s']:.3f} ms, "
                  f"decode {decode_ms:.3f} ms/step over {steps} steps, "
                  f"{b * 1e3 / decode_ms:.1f} tokens/s; 4 profiled steps: wall "
                  f"{1e3 * r['wall_p']:.3f} ms, device busy {r['busy_us'] / 1e3:.3f} ms, idle "
                  f"share {1 - r['busy_us'] / 1e3 / (r['wall_p'] * 1e3):.4f}; launches "
                  f"{r['launches']}; seconds: model and sound run "
                  f"{r['parts'][0]:.1f}, census steps {r['parts'][1]:.1f}, faults "
                  f"{r['parts'][2]:.1f}, phase 20 {r['parts'][3]:.1f}", flush=True)
            print(f"tp serve[{arch}, rank {rank}]: against the whole model, worst |d| / (5e-3 "
                  f"+ 5e-3 |want|) {max(x for x, _ in gaps):.4g} (prefill {gaps[0][0]:.4g}; "
                  f"limit {limit}), worst error in units of the largest logit "
                  f"{max(y for _, y in gaps):.4g}; the reference path against the whole "
                  f"model (the bf16 floor, not held): {max(x for x, _ in floor):.4g}, "
                  f"{max(y for _, y in floor):.4g}; greedy tokens not the first argmax of "
                  f"their logits {wrong}, equal to the whole model's "
                  f"{agree}/{sum(w.argmax(-1).numel() for w in want)}", flush=True)
            print(f"tp serve[{arch}, rank {rank}]: planted faults (|d| / (5e-3 + 5e-3 "
                  f"|want|) over prefill and the decode steps served until caught; "
                  f"greedy tokens changed from the sound run's): " + ", ".join(
                      f"{k} {v:.4g}, {n} tokens ({s} of {TP_FAULTS[k][1]} steps)"
                      for k, (v, n, s) in faults.items()), flush=True)
            for kind, census, peak in (("prefill", r["census_p"], r["peak_p"]),
                                       ("decode", r["census_d"], r["peak_d"])):
                rec = counted[arch, kind]
                print(f"tp serve[{arch}, rank {rank}, {kind} step]: census {census} (dry run "
                      f"{rec['collectives']}); peak {peak} bytes, the dry run's "
                      f"{rec['peak_bytes']}: {100 * (rec['peak_bytes'] - peak) / peak:+.2f}%",
                      flush=True)
    for arch, rank, r, gaps, wrong, faults in checks:
        cfg = get_config(arch)
        for kind, census, peak in (("prefill", r["census_p"], r["peak_p"]),
                                   ("decode", r["census_d"], r["peak_d"])):
            rec = counted[arch, kind]
            assert census == rec["collectives"], (arch, rank, kind, census, rec["collectives"])
            assert abs(rec["peak_bytes"] - peak) <= TP_PEAK_RTOL * peak, (arch, rank, kind, peak)
        want_launches = {**{k: 0 for k in r["launches"]}, **serve_launches(cfg, steps)}
        assert r["launches"] == want_launches, (arch, rank, r["launches"], want_launches)
        assert max(x for x, _ in gaps) <= TP_LIMIT[arch], (arch, "logits", gaps)
        assert wrong == 0, (arch, "vocab-parallel greedy tokens", wrong)
        assert sorted(faults) == sorted(n for n, f in TP_FAULTS.items() if f[0] == arch)
        for name, (reading, changed, _) in faults.items():
            assert reading > TP_LIMIT[arch] or changed > 0, (
                "a planted fault passed", arch, name, reading, changed)
        assert 0 <= int(r["token"].min()) and int(r["token"].max()) < cfg.vocab_size
    seq_checks = []
    fault_cases = _seq_plants()[1]
    for name, (arch, _) in SEQ_CASES.items():  # phase 20
        rec = counted[name, "seqshard"]
        for rank in sorted(got):
            r = got[rank][arch]["seq"][name]
            gap = _tp_gap(r["logits"], seq_wants[name])
            launches = {k: n for k, n in r["launches"].items() if n}
            seq_checks.append((name, rank, r, gap, launches))
            print(f"seqshard prefill[{name}, {TP_SERVE['mesh']}, rank {rank}, gloo host-staged, "
                  f"2 processes on one card, {smi}]: prefill {1e3 * r['prefill_s']:.3f} ms "
                  f"(phase 18's tensor-parallel prefill of the prompt "
                  f"{1e3 * got[rank][arch]['prefill_s']:.3f} ms); profiled: wall "
                  f"{1e3 * r['wall_p']:.3f} ms, device busy {r['busy_us'] / 1e3:.3f} ms, idle "
                  f"share {1 - r['busy_us'] / 1e3 / (r['wall_p'] * 1e3):.4f}; launches "
                  f"{launches} (dry run {rec['launches']})", flush=True)
            print(f"seqshard prefill[{name}, rank {rank}]: last-token logits against the whole "
                  f"model, worst |d| / (5e-3 + 5e-3 |want|) {gap[0]:.4g} (limit "
                  f"{SEQ_LIMIT[name]}), worst error in units of the largest logit "
                  f"{gap[1]:.4g}; census {r['census']} (dry run {rec['collectives']}); peak "
                  f"{r['peak']} bytes, the dry run's {rec['peak_bytes']}: "
                  f"{100 * (rec['peak_bytes'] - r['peak']) / r['peak']:+.2f}%", flush=True)
            if r["faulty"]:
                print(f"seqshard prefill[{name}, rank {rank}]: planted faults (|d| / (5e-3 + "
                      f"5e-3 |want|)): " + ", ".join(f"{k} {v:.4g}"
                                                     for k, v in r["faulty"].items()),
                      flush=True)
    for name, rank, r, gap, launches in seq_checks:
        rec = counted[name, "seqshard"]
        assert r["census"] == rec["collectives"], (name, rank, r["census"], rec["collectives"])
        assert abs(rec["peak_bytes"] - r["peak"]) <= SEQ_PEAK_RTOL * r["peak"], (name, rank)
        assert launches == rec["launches"], (name, rank, launches, rec["launches"])
        assert gap[0] <= SEQ_LIMIT[name], (name, rank, "seqshard logits", gap)
        assert sorted(r["faulty"]) == sorted(f for f, c in fault_cases.items() if c == name)
        for fault, reading in r["faulty"].items():
            assert reading > SEQ_LIMIT[name], ("a planted fault passed", name, fault, reading)
    print(f"tp serve: phase {time.perf_counter() - t_phase:.1f}s (the whole models and the "
          f"dry run's counts {t_spawn - t_phase:.1f}s while the two processes started, then "
          f"the two processes {time.perf_counter() - t_spawn:.1f}s)", flush=True)
    return {**{arch: got[0][arch]["launches"] for arch in TP_ARCHS},
            **{"seqshard " + name: got[0][arch]["seq"][name]["launches"]
               for name, (arch, _) in SEQ_CASES.items()}}


# phase 19: the tensor-parallel train step over two processes sharing the card
TP_TRAIN_MESH = "pods:1x1x2"
# arch -> the pattern repetitions run (None: full depth).  zamba2-2.7b's 9
# repetitions (54 layers) would move ~40 GB a rank a step through gloo and
# the host, ~100 s at its ~0.4 GB/s: the time limit cuts it to one (6 layers)
TP_TRAIN_ARCHS = {"gemma3-1b": None, "granite-moe-1b-a400m": None, "zamba2-2.7b": 1}
TP_TRAIN_JOIN_S = 900  # both ranks' answers for every arch, then they are killed
# the round start's (beta, eta1 coeff) from the ranks' slices against the
# whole tree's: f32 sums of ~1e9 products in another order.  Its noise
# deltas are scaled so that |dp|^2 ~ 1: at |dp|^2 >> 1, coeff = 1 -
# |dp|^2 / (1 + |dp|^2) cancels to a few f32 ulps of 1 and no longer reads
# the sums (an H100 run at |dp|^2 ~ 1e5 read the same bits with the
# round-start fault planted)
TP_ROUND_RTOL = 1e-5
# the step's loss against the one-process step's: the local steps' second
# gradient starts from bf16 parameters that the TP and the whole first
# step round differently (an H100 run read 1.27e-5 for gemma3-1b, 3.2e-6
# and 4.3e-6 for granite-moe and zamba2: the limit is 1.5x the largest)
TP_TRAIN_LOSS_RTOL = 2e-5
# each arch's limits on ``grad_gaps``' (scale drift, error ratio) of the
# gradient from the slices: phase 15's where the sound run fits them
# (gemma3-1b read 1.23e-3 / 1.010 on an H100); granite-moe's sound run reads
# an error ratio of 1.053 (the row all-reduces round each rank's partial
# to bf16 before the sum), held at twice its excess over 1; zamba2's (6
# layers) reads a scale drift of 5.111e-3, held at 1.34x (phase 18's rule),
# and an error ratio of 1.025 inside phase 15's
TP_GRAD_LIMITS = {"gemma3-1b": (GRAD_SCALE_TOL, GRAD_RATIO_TOL),
                  "granite-moe-1b-a400m": (GRAD_SCALE_TOL, 1.10),
                  "zamba2-2.7b": (6.85e-3, GRAD_RATIO_TOL)}
# planted faults: name -> its arch; the gradient faults are held by
# ``grad_gaps``' limits, the round-start fault by ``TP_ROUND_RTOL``
TP_TRAIN_FAULTS = {"attention_input_enter_dropped": "gemma3-1b",
                   "kv_gather_backward_a_plain_slice": "gemma3-1b",
                   "ce_logsumexp_local": "gemma3-1b",
                   "moe_gates_rank_local": "granite-moe-1b-a400m",
                   "ssm_norm_statistic_backward_local": "zamba2-2.7b",
                   "ssm_per_head_leaves_rank_local": "zamba2-2.7b",
                   "round_start_counts_replicated_on_every_rank": "gemma3-1b"}


def _tp_train_cfg(arch):
    """``arch``'s full config, its depth cut to ``TP_TRAIN_ARCHS``' repetitions."""
    return depth_cut(arch, TP_TRAIN_ARCHS[arch])


def _ce_logsumexp_local(logits, labels, tp):
    """A planted fault: the vocab-parallel CE with its logsumexp over this
    rank's slice only."""
    from repro_torch.models import parallel

    logits = logits.float()
    n = logits.shape[-1]
    top = logits.amax(-1).detach()
    se = torch.exp(logits - top[..., None]).sum(-1)
    local = labels.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = parallel.reduce(torch.where(inside, gold, torch.zeros_like(gold)), tp)
    return (torch.log(se) + top - gold).mean()


def _rms_noscale_local(x, tp, whole, eps=1e-6):
    """A planted fault: ``parallel.rms_noscale`` whose statistic's backward
    keeps this rank's heads' share (no ``enter`` after the all-reduce)."""
    from repro_torch.models import parallel

    x32 = x.float()
    ss = parallel.reduce((x32 * x32).sum(dim=-1, keepdim=True), tp)
    return (x32 * torch.rsqrt(ss / whole + eps)).to(x.dtype)


def _per_head_local(p, hs, tp):
    """A planted fault: ``ssm._per_head`` reading the SSM's per-head leaves
    on this rank's heads without ``enter``: their gradient rank-local."""
    if hs is None:
        return p["dt_bias"], p["A_log"], p["D"]
    return p["dt_bias"][hs], p["A_log"][hs], p["D"][hs]


def _tp_train_plants():
    """``TP_TRAIN_FAULTS``' replacements: name -> (module, attribute, fault)."""
    import dataclasses

    from repro_torch.core import pfedsop
    from repro_torch.models import attention, moe, parallel, ssm

    personalize = pfedsop._personalize_tp
    return {
        "attention_input_enter_dropped": (attention, "_block_input", lambda x, tp: x),
        "kv_gather_backward_a_plain_slice": (attention, "_whole_kv", lambda k, v, tp: (k, v)),
        "ce_logsumexp_local": (parallel, "cross_entropy", _ce_logsumexp_local),
        "moe_gates_rank_local": (moe, "_gates", lambda w, tp: w),
        "ssm_norm_statistic_backward_local": (parallel, "rms_noscale", _rms_noscale_local),
        "ssm_per_head_leaves_rank_local": (ssm, "_per_head", _per_head_local),
        # every rank taking itself for rank 0: the replicated leaves counted twice
        "round_start_counts_replicated_on_every_rank": (
            pfedsop, "_personalize_tp",
            lambda params, ld, gd, cfg, impl, tp, split: personalize(
                params, ld, gd, cfg, impl, dataclasses.replace(tp, rank=0), split)),
    }


def _tp_train_count(cfg, pcfg):
    """Rank 0's TP train step at phase 15's shape counted on the meta device
    in a 2-rank fake world (``dryrun.fake_world``, ``dryrun.count``): its
    inputs at rest as rank 0's slices.  Returns (the count, the census)."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.weights import cut

    with dryrun.fake_world(2):
        tp = lm_steps.tensor_parallel(parse_mesh(TP_TRAIN_MESH))
        specs = lm_steps.input_specs(cfg, LAUNCH_SHAPE, micro_batch=LM["batch"])
        state = {k: cut(v, rank_plan(v, "params", 1, tp.size, 0, tp.rank, client=True))
                 for k, v in specs["state"].items()}
        gd = cut(specs["global_delta"], rank_plan(specs["global_delta"], "params", 1, tp.size,
                                                  0, tp.rank))
        step = lm_steps.make_train_step(cfg, LAUNCH_SHAPE, pcfg, tp=tp)
        collectives.reset_census()
        _, c = dryrun.count(step, (state, gd, specs["batches"]))
        return c, collectives.census()


def _tp_grads(cfg, leaves, treedef, batch, tp):
    """The gradient leaves of ``tf.lm_loss`` with ``tp`` at this rank's
    slices ``leaves``."""
    ps = [x.detach().requires_grad_() for x in leaves]
    loss = tf.lm_loss(tree_unflatten(treedef, ps), cfg, batch, tp)
    return torch.autograd.grad(loss, ps)


def _sliced_grad_gaps(g_k, g_r, g_t, counted, numel, tp):
    """``grad_gaps`` from every rank's slices: per leaf the f32 sums
    <g_k - g_r, g_r>, |g_r|^2, |g_k - g_t|^2 and |g_r - g_t|^2 over the
    rank's elements (a replicated leaf on rank 0 only), summed over the
    ranks in f64.  Returns (scale drift, error ratio, the index of the leaf
    whose scale drift is the largest)."""
    from repro_torch.launch import collectives

    sums = torch.zeros((len(g_k), 4), dtype=torch.float64)
    for i, (k, r, t) in enumerate(zip(g_k, g_r, g_t)):
        if counted[i]:
            k, r, t = k.float(), r.float(), t.float()
            sums[i] = torch.stack([((k - r) * r).sum(), (r * r).sum(), ((k - t) ** 2).sum(),
                                   ((r - t) ** 2).sum()]).double().cpu()
    sums = collectives.all_reduce(sums, tp.group)
    drifts = [abs(a) / b for a, b, _, _ in sums.tolist()]
    scale = max(drifts)
    ratio = max(math.sqrt(c / d) for (_, _, c, d), n in zip(sums.tolist(), numel)
                if n >= GRAD_RATIO_NUMEL)
    return scale, ratio, drifts.index(scale)


def _round_start_scalars(cfg, pcfg, params, tp, split, plan):
    """The round start's (beta, eta1 coeff) from this rank's slices of
    ``params`` and of seeded noise deltas (``tree_personalize``'s ``tp``),
    and the whole tree's (K1 over the whole flat vectors, on rank 0)."""
    from repro_torch.core import pfedsop
    from repro_torch.utils.pytree import FlatLayout
    from repro_torch.weights import cut

    dev = params[0].device
    g = torch.Generator(device=dev).manual_seed(7)
    sigma = (2.0 / sum(x.numel() for x in params)) ** 0.5  # |dp|^2 ~ 1: TP_ROUND_RTOL
    ld, gd = ([(sigma * torch.randn(x.shape, generator=g, device=dev)).to(x.dtype)
               for x in params] for _ in range(2))
    treedef = plan[1]
    mine = [cut(tree_unflatten(treedef, t), plan[0]) for t in (params, ld, gd)]
    _, aux = pfedsop.tree_personalize(*mine, pcfg, tp=tp, split=split)
    got = (aux["beta"].item(), aux["eta_coeff"].item())
    del mine, aux
    whole = None
    if tp.rank == 0:
        layout = FlatLayout(params)
        dv, gv = layout.flatten(ld), layout.flatten(gd)
        beta, ec = ops.scalars_from_partials(ops.reduce3_batched(dv[None], gv), pcfg.eta1,
                                             pcfg.rho, pcfg.lam, pcfg.eps)
        whole = (beta.item(), ec.item())
        del dv, gv
    del ld, gd
    return got, whole


def _tp_train_rank(rank, port, answers):
    """One of two processes on the one card (gloo), ``pods:1x1x2``, for each
    arch of ``TP_TRAIN_ARCHS``: phase 15's step inputs (seed 0) at rest as
    this rank's slices, ``make_train_step(tp=)`` under the profiler with
    the counters and the census reset just before (launches, census, peak,
    wall, the device's busy time), its loss and the digests of its
    replicated outputs; for the archs of ``TP_GRAD_LIMITS`` the
    first local step's gradient on the slices held by ``grad_gaps`` against the whole
    model's reference and f32 gradients (each rank computes them and keeps
    its slices), and under each planted gradient fault of the
    arch; for gemma3-1b the round start's scalars, sound and under the
    round-start fault."""
    import datetime
    import traceback

    import torch.distributed as dist

    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.sharding import rank_plan
    from repro_torch.weights import cut

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=300))
        try:
            tp = lm_steps.tensor_parallel(parse_mesh(TP_TRAIN_MESH))
            pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0)
            plants = _tp_train_plants()
            out = {}
            for arch in TP_TRAIN_ARCHS:
                marks = [time.perf_counter()]  # the seconds of each part, below
                cfg = _tp_train_cfg(arch)
                r = {}
                state, gd, batches = launch_step_args(cfg, n=None)
                params, treedef = tree_flatten(tree_map(lambda x: x[0], state["params"]))
                pplan = rank_plan(tree_unflatten(treedef, params), "params", 1, tp.size, 0,
                                  tp.rank)
                split = lm_steps.split_leaves(cfg, tp)
                args = ({k: cut(v, rank_plan(v, "params", 1, tp.size, 0, tp.rank, client=True))
                         for k, v in state.items()}, cut(gd, pplan), batches)
                del state, gd
                gc.collect()
                torch.cuda.empty_cache()
                step = lm_steps.make_train_step(cfg, LAUNCH_SHAPE, pcfg, tp=tp)
                def timed():
                    t1 = time.perf_counter()
                    out = step(*args)
                    torch.cuda.synchronize()
                    return out, time.perf_counter() - t1

                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                collectives.reset_census()
                reset_launches()
                (new_state, new_gd, loss), r["wall"], r["busy_us"] = profiled_run(timed)
                r["launches"] = all_launches()
                r["census"] = collectives.census()
                r["peak"] = _storage_bytes(args) + torch.cuda.max_memory_allocated() - base
                r["loss"] = loss.item()
                kept = [x for x, p in zip(tree_leaves((new_state["params"], new_state["delta"],
                                                       new_gd)), 3 * tree_leaves(pplan))
                        if not p.cuts]
                r["digests"] = tree_digest([loss] + kept)
                del new_state, new_gd, loss, kept
                marks.append(time.perf_counter())

                if arch in TP_GRAD_LIMITS:
                    first = {k: v[0, 0] for k, v in batches.items()}
                    ref_cfg = cfg.replace(kernel_impl="reference")
                    # the whole model's gradients (both ranks at once: ~2 x 21 GB at
                    # gemma3-1b's f32), this rank's slices kept
                    g_r, g_t = (tree_leaves(cut(tree_unflatten(treedef, list(
                        loss_and_grads(c, params, treedef, first, f32=f32)[1])), pplan))
                        for c, f32 in ((ref_cfg, False), (ref_cfg.replace(dtype="float32"), True)))
                    gc.collect()
                    torch.cuda.empty_cache()
                    mine = tree_leaves(tree_map(lambda x: x[0], args[0]["params"]))
                    counted = [s or tp.rank == 0 for s in split]
                    numel = [x.numel() for x in params]
                    r["leaves"] = [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
                                   for x in params]
                    mtp = lm_steps._model_only(tp)
                    r["grad"] = _sliced_grad_gaps(_tp_grads(cfg, mine, treedef, first, mtp),
                                                  g_r, g_t, counted, numel, tp)
                    r["grad_faults"] = {}
                    for name in (n for n, a in TP_TRAIN_FAULTS.items() if a == arch
                                 and n != "round_start_counts_replicated_on_every_rank"):
                        module, attr, fault = plants[name]
                        sound = getattr(module, attr)
                        setattr(module, attr, fault)
                        try:
                            g_f = _tp_grads(cfg, mine, treedef, first, mtp)
                        finally:
                            setattr(module, attr, sound)
                        r["grad_faults"][name] = _sliced_grad_gaps(g_f, g_r, g_t, counted,
                                                                   numel, tp)
                        del g_f
                    del g_r, g_t, mine
                marks.append(time.perf_counter())
                if arch == "gemma3-1b":
                    mtp = lm_steps._model_only(tp)
                    r["round"] = _round_start_scalars(cfg, pcfg, params, mtp, split,
                                                      (pplan, treedef))
                    name = "round_start_counts_replicated_on_every_rank"
                    module, attr, fault = plants[name]
                    sound = getattr(module, attr)
                    setattr(module, attr, fault)
                    try:
                        r["round_fault"] = _round_start_scalars(cfg, pcfg, params, mtp, split,
                                                                (pplan, treedef))
                    finally:
                        setattr(module, attr, sound)
                marks.append(time.perf_counter())
                r["parts"] = np.diff(marks).tolist()
                out[arch] = r
                del args, params, batches, step
                gc.collect()
                torch.cuda.empty_cache()
            answers.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent fails the phase with this traceback
        answers.put((rank, False, traceback.format_exc()))


def tp_train_run():
    """Phase 19: the tensor-parallel train step (``make_train_step(tp=)``)
    of each arch of ``TP_TRAIN_ARCHS`` at full width in bf16, at phase 15's
    shape (one client, B = 2, S = 2048, T = 2), on ``pods:1x1x2`` by two
    processes sharing the card (gloo, host-staged; one spawn for every
    arch), each rank its model slices.  Per arch: each rank's census equal
    to rank 0's step counted on meta tensors in a 2-rank fake world, its
    peak within ``TP_PEAK_RTOL`` of the count's and its K1/K2/K4-K7
    launches the count's; the loss bitwise equal across the ranks and
    within ``TP_TRAIN_LOSS_RTOL`` of the one-process step's, every
    replicated leaf of the outputs bitwise equal across the ranks; for the
    archs of ``TP_GRAD_LIMITS`` the first local step's gradient from the
    slices within the arch's ``grad_gaps`` limits of the whole model's, and
    each planted gradient fault of the arch outside them; for gemma3-1b the
    round start's (beta, eta1 coeff) within ``TP_ROUND_RTOL`` of the whole
    tree's and the round-start fault outside it; step wall and idle share
    with the card's name and power limit.  Returns rank 0's launches per
    arch."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0)
    counted, whole_loss = {}, {}

    def prepare():  # while the ranks start; they allocate once it is done
        nonlocal t_spawn
        for arch in TP_TRAIN_ARCHS:
            cfg = _tp_train_cfg(arch)
            if TP_TRAIN_ARCHS[arch] is not None:
                print(f"tp train[{arch}]: depth cut to {cfg.n_layers} of "
                      f"{get_config(arch).n_layers} layers ({TP_TRAIN_ARCHS[arch]} pattern "
                      "repetition): the full depth would move ~40 GB a rank a step through "
                      "gloo", flush=True)
            t0 = time.perf_counter()
            counted[arch] = _tp_train_count(cfg, pcfg)
            args = launch_step_args(cfg, n=None)
            whole_loss[arch] = lm_steps.make_train_step(cfg, LAUNCH_SHAPE, pcfg)(
                *args)[2].item()
            print(f"tp train[{arch}]: rank 0's step counted on meta in a 2-rank fake world "
                  f"and the one-process step run in {time.perf_counter() - t0:.1f}s",
                  flush=True)
            del args
            gc.collect()
            torch.cuda.empty_cache()
        t_spawn = time.perf_counter()
        return ()

    t_spawn = None
    got = _spawn_two(_tp_train_rank, (), TP_TRAIN_JOIN_S, prepare)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for arch in TP_TRAIN_ARCHS:
        c, census = counted[arch]
        for rank in sorted(got):
            r = got[rank][arch]
            print(f"tp train[{arch}, {TP_TRAIN_MESH}, rank {rank}, gloo host-staged, 2 "
                  f"processes on one card, {smi}]: step wall {1e3 * r['wall']:.3f} ms "
                  f"(profiled), device busy {r['busy_us'] / 1e3:.3f} ms, idle share "
                  f"{1 - r['busy_us'] / 1e3 / (r['wall'] * 1e3):.4f}; loss {r['loss']!r} "
                  f"(one process {whole_loss[arch]!r}); launches {r['launches']} (count "
                  f"{c['launches']}); census {r['census']} (count {census}); peak {r['peak']} "
                  f"bytes, the count's {c['peak']}: "
                  f"{100 * (c['peak'] - r['peak']) / r['peak']:+.2f}%; seconds: inputs and "
                  f"the step {r['parts'][0]:.1f}, gradients and their faults "
                  f"{r['parts'][1]:.1f}, round start {r['parts'][2]:.1f}", flush=True)
            if "grad" in r:
                tol, (scale, ratio, worst) = TP_GRAD_LIMITS[arch], r["grad"]
                print(f"tp train[{arch}, rank {rank}]: the first local step's gradient from "
                      f"the slices against the whole model's: scale drift {scale:.4g} (tol "
                      f"{tol[0]:.4g}; largest on leaf {worst}, {r['leaves'][worst]}), error "
                      f"against f32 over the reference path's {ratio:.4g} (tol {tol[1]:.4g}); "
                      "planted faults: " + ", ".join(f"{n} {a:.4g} / {b:.4g}" for n, (a, b, _)
                                                     in r["grad_faults"].items()), flush=True)
            if "round" in r:
                print(f"tp train[{arch}, rank {rank}]: the round start's (beta, eta1 coeff) "
                      f"from the slices {r['round'][0]}, the whole tree's {r['round'][1]}; "
                      f"under the round-start fault {r['round_fault'][0]}", flush=True)
    for arch in TP_TRAIN_ARCHS:
        c, census = counted[arch]
        ranks = [got[rank][arch] for rank in sorted(got)]
        for r in ranks:
            want = {**{k: 0 for k in r["launches"]}, **c["launches"]}
            assert r["launches"] == want, (arch, r["launches"], want)
            assert r["census"] == census, (arch, r["census"], census)
            assert abs(c["peak"] - r["peak"]) <= TP_PEAK_RTOL * r["peak"], (arch, r["peak"])
            assert math.isfinite(r["loss"]), (arch, r["loss"])
            assert abs(r["loss"] - whole_loss[arch]) <= TP_TRAIN_LOSS_RTOL * abs(
                whole_loss[arch]), (arch, r["loss"], whole_loss[arch])
        assert all(r["digests"] == ranks[0]["digests"] for r in ranks), (arch, "replicated")
        if arch in TP_GRAD_LIMITS:
            r, (scale_tol, ratio_tol) = ranks[0], TP_GRAD_LIMITS[arch]
            assert r["grad"][0] <= scale_tol and r["grad"][1] <= ratio_tol, (arch, r["grad"])
            faults = [n for n, a in TP_TRAIN_FAULTS.items() if a == arch and n in
                      r["grad_faults"]]
            assert faults, arch
            for name in faults:
                sc, ra, _ = r["grad_faults"][name]
                assert sc > scale_tol or ra > ratio_tol, ("a planted fault passed", name, sc, ra)
        if arch == "gemma3-1b":
            (tp_s, whole), (fault_s, _) = ranks[0]["round"], ranks[0]["round_fault"]
            assert all(r["round"][0] == tp_s for r in ranks), "the ranks' scalars differ"
            for got_v, want_v in zip(tp_s, whole):
                assert abs(got_v - want_v) <= TP_ROUND_RTOL * abs(want_v), (tp_s, whole)
            assert any(abs(f - w) > TP_ROUND_RTOL * abs(w) for f, w in zip(fault_s, whole)), (
                "a planted fault passed", fault_s, whole)
    print(f"tp train: phase {time.perf_counter() - t_phase:.1f}s (the counts and the "
          f"one-process steps {t_spawn - t_phase:.1f}s while the two processes started, then "
          f"the two processes {time.perf_counter() - t_spawn:.1f}s)", flush=True)
    return {arch: got[0][arch]["launches"] for arch in TP_TRAIN_ARCHS}


def _kernel_name(mangled):
    """``name<args>`` of a mangled kernel in the anonymous namespace: the
    identifier ending in ``_kernel`` whose length prefix matches it (the
    namespace's own name ends in digits too), then its template's int and
    bool arguments."""
    end = mangled.index("_kernel") + len("_kernel")
    for start in range(end - 1, 0, -1):
        n = str(end - start)
        if mangled[start].isalpha() and mangled[:start].endswith(n):
            args = re.match(r"I(\w+?)E*v", mangled[end:])
            vals = re.findall(r"L[ib](\d+)", args.group(1) if args else "")
            return f"{mangled[start:end]}<{', '.join(vals)}>"
    return mangled


def print_ptxas(source, expect=()):
    """Registers, shared memory and spills of each kernel in ``source``, from
    the ``-Xptxas -v`` report the build keeps, and any note that ptxas
    serialized a kernel's wgmma products (C7515, C7520).  A spill or such a
    note fails the run, naming the kernel: the tensor-core kernels' f32
    accumulators are sized to fit their registers, and a serialized wgmma
    waits for each product in turn, which no kernel here is shaped for (the
    note names its function; where it does not, it falls in the section of
    the kernel whose entry ptxas compiled last).  So does a kernel of
    ``expect`` (``name<args>``) that the report does not name."""
    name, faults, seen = None, [], set()
    for line in kernel_build.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\w+_kernel\w*)'", line)
        if m:
            name = _kernel_name(m.group(1))
            seen.add(name)
        elif "wgmma" in line:
            print(f"build[ptxas]: {line.strip()}", flush=True)
            if "serialized" in line:  # ptxas serialized a kernel's wgmma pipeline
                named = re.search(r"function '(\w+_kernel\w*)'", line)
                faults.append((_kernel_name(named.group(1)) if named else name, line.strip()))
        elif name and ("registers" in line or "spill" in line):
            print(f"build[ptxas {name}]: {line.split(':', 1)[-1].strip()}", flush=True)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spills and spills.groups() != ("0", "0"):
                faults.append((name, line.strip()))
    faults += [(want, "not in the report") for want in expect if want not in seen]
    assert not faults, faults


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test runs "
              "on a CUDA card only", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} capability {cap}",
          flush=True)
    assert cap == (9, 0), cap

    t0 = time.perf_counter()

    def lap(done):
        """The seconds since the build began, after the phases ``done``."""
        print(f"time[{done}]: {time.perf_counter() - t0:.1f}s since the build began",
              flush=True)

    kernel_build.build(ops.SOURCE, rms_ops.SOURCE, flash_ops.SOURCE, flash_ops.SM90_SOURCE)
    for mod in (ops, rms_ops, flash_ops):
        mod.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    print_ptxas(flash_ops.SM90_SOURCE)
    print_ptxas(flash_ops.SOURCE, [f"fwd_tf32_kernel<{d}>" for d in flash_ops.TF32_FWD_HEAD_DIMS])

    rec = check_kernels()
    for k, r in check_update_c1().items():
        rec[k].update(r)
    ranges = time_ranges()
    rec["rmsnorm"] = check_rmsnorm()
    worst = check_flash()
    for key, err in check_flash_offset().items():
        worst[key] = max(worst[key], err)
    # the LM slice's gemma3-1b (H = 4 over KV = 1, D = 256; 4 full-attention
    # layers, 22 at window 512), then zamba2's shared attention at D = 80
    rec.update(time_flash(4, 1, 256, (None, 512), seed=13))
    for key, recs in time_flash_other_shapes().items():
        for name, r in recs.items():
            rec[name][key] = r
    rec["flash_fwd"]["q_offset"] = time_flash_offset()
    # f32 (flash_gqa.cu): granite-moe's training shape, the others under their keys
    f32_times = time_flash_f32()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        rec[name + "_f32"] = {**f32_times["f32_d64"][name], **{
            key: recs[name] for key, recs in f32_times.items() if key != "f32_d64"}}
    for name, err in worst.items():
        rec[name]["max_abs_err"] = err
    l2_flush.cache_clear()  # the timing phases are over: free the flush buffer
    torch.cuda.empty_cache()
    lap("phases 2-3")
    small_parity()
    lm_small_parity()
    resnet = slice_run()
    lm = lm_slice()
    lap("phases 4-6")
    methods = methods_run()
    torch.backends.cudnn.deterministic = True  # the bitwise phases below
    sync_vs_async()
    hetero, hist = async_run()
    async_resume(hist)
    lap("phases 7-10")
    stores, hetero_host = stores_run(hist)
    serve = serve_run()
    shutil.rmtree(SCRATCH)
    paths = {"resnet9": resnet, "lm_gemma3_1b": lm, "resnet9_methods": methods,
             "resnet9_async": hetero, "resnet9_stores": stores,
             "resnet9_async_host": hetero_host, "serve_gemma3_1b": serve}
    for arch in ARCH_TRAIN:
        paths["lm_" + arch.replace("-", "_").replace(".", "_")] = arch_train_run(arch)
    for arch in ARCH_SERVE_N:
        paths["serve_" + arch.replace("-", "_").replace(".", "_")] = arch_serve_run(arch)
    lap("phases 11-14")
    for arch, launches in launch_tooling_run().items():
        paths["train_step_" + arch.replace("-", "_").replace(".", "_")] = launches
    paths.update(scripts_run())
    mesh_paths, worst = mesh_run()
    paths.update(mesh_paths)
    paths.update(mesh_train_run())
    lap("phases 15-17")
    for arch, launches in tp_serve_run().items():  # phases 18 and 20
        name = ("seqshard_prefill_" + arch.split()[1] if arch.startswith("seqshard ")
                else "tp_serve_" + arch)
        paths[re.sub(r"[-./]", "_", name) + "_rank0"] = launches
    for arch, launches in tp_train_run().items():
        paths["tp_train_" + arch.replace("-", "_").replace(".", "_") + "_rank0"] = launches
    lap("phases 18-20")
    for k in ("reduce3", "update"):
        rec[k + "_range"] = {**ranges[k], "max_abs_err": worst[k]}

    def record(name, key, source, replaces):
        """The JSON record of ``rec[key]``: launches under ``key`` summed over
        ``paths``."""
        r = dict(rec[key])
        r.setdefault("library_ms", None)
        by_path = {p: counts.get(key, 0) for p, counts in paths.items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), **r, "launches_by_path": by_path}

    kernels = [
        record("pfedsop_reduce3", "reduce3", SOURCE,
               "src/repro/kernels/pfedsop_update/kernel.py:132"),
        record("pfedsop_update", "update", SOURCE,
               "src/repro/kernels/pfedsop_update/kernel.py:163"),
        record("rmsnorm", "rmsnorm", RMS_SOURCE, "src/repro/kernels/rmsnorm/kernel.py:28"),
        record("flash_fwd", "flash_fwd", FLASH_SM90_SOURCE,
               "src/repro/kernels/flash_gqa/kernel.py:176"),
        record("flash_bwd_dq", "flash_bwd_dq", FLASH_SM90_SOURCE,
               "src/repro/kernels/flash_gqa/kernel.py:394"),
        record("flash_bwd_dkv", "flash_bwd_dkv", FLASH_SM90_SOURCE,
               "src/repro/kernels/flash_gqa/kernel.py:436"),
        record("flash_bwd_dkv_sum", "flash_bwd_dkv_sum", FLASH_SM90_SOURCE,
               "src/repro/kernels/flash_gqa/kernel.py:436"),
        # f32 (flash_gqa.cu), counted under f32's own keys wherever a path
        # runs in f32 (phase 15's f32 step, the reduced configs' scripts)
        record("flash_fwd_f32", "flash_fwd_f32", FLASH_SOURCE,
               "src/repro/kernels/flash_gqa/kernel.py:176"),
        record("flash_bwd_dq_f32", "flash_bwd_dq_f32", FLASH_SOURCE,
               "src/repro/kernels/flash_gqa/kernel.py:394"),
        record("flash_bwd_dkv_f32", "flash_bwd_dkv_f32", FLASH_SOURCE,
               "src/repro/kernels/flash_gqa/kernel.py:436"),
        # K1/K2 on one model rank's tile range (repro's
        # pfedsop_update_batched_sharded, ops.py:112): rank 0 of m = 2
        record("pfedsop_reduce3_tile_range", "reduce3_range", SOURCE,
               "src/repro/kernels/pfedsop_update/kernel.py:132"),
        record("pfedsop_update_tile_range", "update_range", SOURCE,
               "src/repro/kernels/pfedsop_update/kernel.py:163"),
    ]
    assert all(k["launches"] > 0 for k in kernels), [(k["name"], k["launches"]) for k in kernels]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
