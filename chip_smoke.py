#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

  1. environment  card name and power limit (nvidia-smi), torch/CUDA
                  versions, compute capability 9.0 asserted;
  2. build        the CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
                  one nvcc per source, all started together; ptxas's
                  registers, shared memory and spills of the tensor-core
                  flash kernels printed, and no spill allowed there;
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
                  zamba2's D = 80 (H = KV = 32, bf16 and f32, and a masked
                  bf16 case; timed too, beside SDPA at D = 80), and phases
                  13-14's shapes: granite-moe's training (H = 16 over KV =
                  8, D = 64, and its sum pass), internvl2's and musicgen's
                  prefill (B = 4, S = 1,024; D = 128 and 64) (bf16
                  K5-K7 run on the tensor cores, ``flash_gqa_sm90.cu``;
                  K6's dq and K7's dk/dv held bitwise across two launches,
                  in f32 before their final rounding within half an ulp,
                  and K7's sum pass bitwise against its plain version); the
                  flash cases at 8 seeds; K6 + K7 timed together beside
                  SDPA's backward.  Device times (torch.profiler; host time
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
                  within 2**-4 of the largest, the loss and its gradient
                  within 4x the sound runs' readings;
 14. arch serve   zamba2-2.7b, internvl2-2b (256 random patch embeddings +
                  768 text tokens) and musicgen-large (4 codebooks, int8 KV
                  cache) at full width and depth, batch 4, a 1,024-position
                  prompt, 32 greedy steps: phase 12's checks (exact K4/K5
                  counts, the first step against a full forward, the
                  reference path within 2**-4) and its prefill ms, decode ms
                  per step, tokens/s and peak memory;
 15. launch       ``launch/dryrun.py``'s prediction for ``steps.make_train_step``
                  at phase 6's shape (gemma3-1b, one client, B = 2, S = 2048,
                  T = 2), counted on the meta device, then the step on the
                  card at full width and depth: the launches equal the
                  prediction's, the peak device memory within 10 % of the
                  predicted peak, the loss within phase 13's limit of the
                  reference path's; the first local step's gradient per leaf
                  against the reference path and an f32 run of it (scale
                  drift and error ratio, ``grad_gaps``), and 7 planted
                  kernel faults each failing that check; the wall and
                  device time, counted FLOPs against ``model_flops``, the
                  roofline terms and the new global delta's gap printed.  Then K1/K2 at C = 1, N = 4 against
                  their plain versions, and ``scripts/torch_smoke_models.py``,
                  ``scripts/torch_smoke_fl.py`` and
                  ``examples/torch_quickstart.py`` on the card.
 16. mesh         a one-rank NCCL group (file store under
                  ``build/chip_smoke``) and the ``clients:1`` and
                  ``pods:1x1x1`` meshes; phase 5's ResNet slice, 3 rounds of
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
                  Each phase prints its seconds, the TP ranks the seconds
                  of their parts, and ``time[...]`` lines the seconds
                  since the build began.

Prints a ``{"kernels": [...]}`` line (each flash record also holds its
D = 80 readings under ``d80``; launches per path under
``launches_by_path``) and ends with
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

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

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

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
from repro_torch.launch import dryrun, profile_store, roofline  # noqa: E402
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
PROFILE_PAD_S = 0.02  # host idle at each end of a profile (see device_ms)


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
    and a synchronize.  The host idles ``PROFILE_PAD_S`` after the session
    starts and before it stops: the profiler drops device events that its
    clock places outside the session, so a launch right at either end is
    not at the mercy of a small offset between the host's and the card's
    clocks."""
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        body()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return device_events(prof)


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
    every other kernel a multiple of ``calls`` times; otherwise (the
    profiler lost or misplaced events, which it does now and then) it is
    taken again, up to ``PROFILE_TRIES`` times, and the run fails if none is
    complete.  ``fn`` itself launching a flush kernel fails every try."""
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


def check_flash(seeds=FLASH_SEEDS):
    """K5-K7 against their plain versions, once for each seed: at the LM
    slice's attention shapes (B = 2, S = 2048, D = 256; gemma3-1b's H = 4
    over KV = 1, i.e. G = 4, and G = 1), window 512 and none, softcap 50 and
    none, bf16 and f32; in bf16 also at D = 64 and 128 (G = 4, window 512 and
    none), at a ragged S = 1,000 (D = 256, window 512), where the last tiles
    are partial, and at S = 40 (D = 64, window 16), shorter than one tile;
    and at zamba2's shared attention, D = 80 (H = KV = 32, no window, bf16
    and f32; the tensor-core tiles pad D to 128 with zero columns), plus a
    masked D = 80 case (G = 2, window 512, softcap 50, ragged S = 1,000).
    Phases 13 and 14's own shapes, bf16, no window: granite-moe's training
    (B = 2, S = 2048, H = 16 over KV = 8, D = 64: G = 2 and its sum pass),
    internvl2's prefill (B = 4, S = 1024, H = 16 over KV = 8, D = 128) and
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
    both and held to 1e-5.

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
    cases and seeds."""
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "flash_bwd_dkv_sum": 0.0}
    worst_rel = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    worst_pre = {"dq": 0.0, "dk/dv": 0.0}  # before the final rounding, bf16
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (G, window, softcap, dtype, S, D, H, B)
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
        (2, None, None, bf16, 2048, 64, 8, 2), (1, None, None, bf16, 2048, 80, 16, 2)]
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
            assert lse_err[1] <= 1e-5, (label, lse_err)
            line = []
            for name, es in pairs.items():
                for err, rel in es:
                    assert rel <= tol, (name, label, err, rel)
                    worst[name] = max(worst[name], err)
                    if dtype == bf16:
                        worst_rel[name] = max(worst_rel[name], rel)
                    line.append(f"{name[6:]} {err:.3g}/{rel:.3g}")
            worst["flash_fwd"] = max(worst["flash_fwd"], lse_err[0])
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
            print(f"kernels[flash {label}]: max_abs_err/relative " + ", ".join(line) +
                  f", lse {lse_err[0]:.3g}/{lse_err[1]:.3g} (tol {tol:.3g}, lse 1e-05); "
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


def time_flash(h, kv, d, windows, seed):
    """Times at one attention shape, bf16, B = 2, S = 2048: the records at a
    full-attention layer, where one PyTorch call,
    ``F.scaled_dot_product_attention``, computes the same function, each
    further window of ``windows`` printed beside them as ``window<w>``, and
    K6 + K7 timed as one backward beside SDPA's; at G > 1 also K7's sum
    pass alone.  Bounds count the visible (query, key) pairs: 4D flops each
    forward, 6D for the dq pass (scores, dO v^T, dq), 8D for the dk/dv pass,
    at the bf16 peak, over the useful D columns.  At D = 80 the kernels'
    products whose N is D run 128 columns (TMA's zero fill), so they do
    (2D + 2*128) / 4D = 1.30x (K5), (4D + 2*128) / 6D = 1.20x (K6) and
    (4D + 4*128) / 8D = 1.30x (K7) of the counted work."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = _attention(g, h, kv, torch.bfloat16, d=d)
    b, s, _, _ = q.shape
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
            bnd, by = roofline.bound_ms(cost)
            # K7's time includes its sum pass over the f32 head partials
            r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, calls=5, warmup=1),
                     bound_ms=bnd, bound_by=by)
            _print_time(f"{name} window={window} B={b} S={s} H={h} KV={kv} D={d} bf16", r)
            if window is None:
                recs[name] = r
            else:
                recs[name][f"window{window}"] = r

    # the library yardstick at the full-attention layer; before PyTorch 2.5
    # SDPA has no enable_gqa, and the KV head is repeated for it beforehand
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    if tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5):
        sdpa = lambda a, b_, c: F.scaled_dot_product_attention(  # noqa: E731
            a, b_, c, is_causal=True, enable_gqa=True)
    else:
        kt, vt = (t.repeat_interleave(h // t.shape[1], dim=1) for t in (kt, vt))
        sdpa = lambda a, b_, c: F.scaled_dot_product_attention(  # noqa: E731
            a, b_, c, is_causal=True)
    want, lse = flash_ops.flash_fwd(q, k, v)
    torch.testing.assert_close(sdpa(qt, kt, vt).transpose(1, 2), want, rtol=2.0 ** -6,
                               atol=2.0 ** -6)
    recs["flash_fwd"]["library_ms"] = device_ms(lambda: sdpa(qt, kt, vt))
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    o = sdpa(*leaves)
    bwd = device_ms(lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True))
    # one call computes dq, dk and dv: the yardstick of both passes together
    recs["flash_bwd_dq"]["library_ms"] = recs["flash_bwd_dkv"]["library_ms"] = bwd
    print(f"kernels[time sdpa full-attention D={d} bf16]: forward "
          f"{recs['flash_fwd']['library_ms']:.4f} ms, backward (dq, dk, dv) {bwd:.4f} ms",
          flush=True)
    delta = flash_ops.row_delta(do, want)
    pair = device_ms(lambda: (flash_ops.flash_bwd_dq(q, k, v, do, lse, delta),
                              flash_ops.flash_bwd_dkv(q, k, v, do, lse, delta)))
    recs["flash_bwd_dq"]["with_dkv_ms"] = pair
    print(f"kernels[time K6 + K7 full-attention D={d} bf16]: {pair:.4f} ms, SDPA's backward "
          f"{bwd:.4f} ms ({pair / bwd:.2f}x)", flush=True)
    if h == kv:
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
    want = {k: steps * v for k, v in lm_driver.launches_per_step(cfg).items()}
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
# are 4x the larger reading.
TRAIN_LOSS_RTOL = 1e-5
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


def arch_train_run(arch):
    """Phase 13: ``train_lm_pfedsop`` at ``arch``'s full width and depth,
    ``LM``'s loop (3 rounds, batch 2, seq_len 2048, 2 local iterations, eta
    0.1, seed 0) with ``ARCH_TRAIN``'s clients and the exact launch counts;
    then one forward of client 0's trained model on the reference path
    against the kernel path.  Returns the launches."""
    t_phase = time.perf_counter()
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

    trained = states[0].params
    states = None
    batch = next(lm_driver.client_streams(cfg, 1, run["batch"], run["seq_len"])[0])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    ref_cfg = cfg.replace(kernel_impl="reference")
    leaves, treedef = tree_flatten(trained)

    def logits(c):
        with torch.no_grad():
            return tf.lm_logits(trained, c, tf.forward(trained, c, batch)[0])

    # per-token logits, as phase 12 holds them: within 2**-4 of the largest
    err, rel = errors(logits(cfg), logits(ref_cfg))
    assert rel <= SERVE_RTOL, (arch, "kernel vs reference logits", err, rel)
    # the loss and its gradient, within 4x the sound runs' readings
    loss_k, grads_k = loss_and_grads(cfg, leaves, treedef, batch)
    loss_r, grads_r = loss_and_grads(ref_cfg, leaves, treedef, batch)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    grad_rel = _tree_gap(grads_k, grads_r)
    print(f"train[{arch}]: client 0's trained model, kernel path against the reference "
          f"path: logits max_abs_err {err:.4g}, relative {rel:.4g} (tol {SERVE_RTOL:.4g}); "
          f"loss {loss_k:.6f} / {loss_r:.6f} (rel diff {loss_rel:.4g}, tol "
          f"{TRAIN_LOSS_RTOL:.4g}); gradient |g_k - g_r| / |g_r| {grad_rel:.4g} (tol "
          f"{TRAIN_GRAD_RTOL:.4g}) over {len(leaves)} leaves; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    assert loss_rel <= TRAIN_LOSS_RTOL, (arch, loss_k, loss_r, loss_rel)
    assert grad_rel <= TRAIN_GRAD_RTOL, (arch, "gradient", grad_rel)
    del trained, batch, leaves, grads_k, grads_r
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


def launch_step_args(cfg, n=LM_N):
    """``make_train_step``'s inputs at phase 6's shape on the card: one
    client's params from seed 0 (``n`` of them, unchecked for None) and
    zero local and global deltas, and client 0's first
    ``LM["local_iters"]`` batches of phase 6's stream."""
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    assert n is None or sum(x.numel() for x in tree_leaves(params)) == n
    state = {"params": tree_map(lambda x: x.unsqueeze(0), params),
             "delta": tree_map(lambda x: torch.zeros_like(x).unsqueeze(0), params)}
    global_delta = tree_map(torch.zeros_like, params)
    stream = lm_driver.client_streams(cfg, 1, LM["batch"], LM["seq_len"])[0]
    bs = [next(stream) for _ in range(LM["local_iters"])]
    batches = {k: torch.from_numpy(np.stack([b[k] for b in bs])[None]).to(
        device="cuda", dtype=torch.int32) for k in bs[0]}
    return state, global_delta, batches


def launch_tooling_run():
    """Phase 15: the dry run's prediction for ``steps.make_train_step`` at
    phase 6's shape (gemma3-1b, one client, B = 2, S = 2048, T = 2, bf16,
    remat "block"), then the step on the card at full width and depth: the
    launches must equal the prediction's, the peak device memory be within
    ``PEAK_RTOL`` of the predicted peak, and the loss within phase 13's limit
    of the reference path's.  The first local step's gradient is held per
    leaf (``grad_gaps``), and each planted fault of ``GRAD_FAULTS`` must fail
    that check.  Prints the wall and device time, the counted FLOPs against
    ``model_flops``, the roofline terms and the new global delta's gap.
    Returns the step's launches."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    assert cfg.remat == "block" and cfg.dtype == "bfloat16", (cfg.remat, cfg.dtype)
    pcfg = PFedSOPConfig(eta1=0.1, eta2=0.1, rho=1.0, lam=1.0)
    t0 = time.perf_counter()
    rec = dryrun.run_one("gemma3-1b", LAUNCH_SHAPE, micro_batch=LM["batch"], save=False,
                         verbose=False)
    mem = rec["memory_analysis"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    print(f"launch[dryrun]: {rec['ops']} ops counted on the meta device in "
          f"{time.perf_counter() - t0:.1f}s: launches {rec['launches']}; memory {mem}, "
          f"peak {predicted} bytes ({predicted / 2**30:.3f} GiB), fits={rec['fits']}; "
          f"flops {rec['cost_analysis']['flops']:.6g}, bytes "
          f"{rec['cost_analysis']['bytes accessed']:.6g}", flush=True)

    base = torch.cuda.memory_allocated()
    args = launch_step_args(cfg)
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
    print(f"launch[step]: wall {1e3 * wall:.3f} ms; launches {launches} (predicted "
          f"{rec['launches']}); peak device memory {measured} bytes ({measured / 2**30:.3f} "
          f"GiB) against the predicted {predicted} ({predicted / 2**30:.3f} GiB): "
          f"{100 * (predicted - measured) / measured:+.2f}% (tol "
          f"{100 * PEAK_RTOL:.0f}%)", flush=True)
    assert launches == want, (launches, want)
    assert abs(predicted - measured) <= PEAK_RTOL * measured, (predicted, measured)

    def again():
        step(*args)

    busy = sum(e.self_device_time_total for e in profiled(
        again, [torch.profiler.ProfilerActivity.CUDA])) / 1e3
    rl = rec["roofline"]
    mf = roofline.model_flops(cfg, LAUNCH_SHAPE)
    print(f"launch[roofline]: device busy {busy:.3f} ms of the step (profiled run); counted "
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
    print(f"launch[step]: kernel path against the reference path: loss {loss_k:.6f} / "
          f"{loss_r:.6f} (rel diff {loss_rel:.4g}, tol {TRAIN_LOSS_RTOL:.4g}); new global "
          f"delta |d_k - d_r| / |d_r| {delta_rel:.4g} (printed only: bf16 rounding of "
          f"sub-ulp updates)", flush=True)
    assert math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_RTOL, (loss_k, loss_r)
    del new_state, new_global, ref_global

    # the first local step's gradient, per leaf, against the reference path
    # and an f32 run of it (``grad_gaps``); then each planted fault of
    # ``GRAD_FAULTS`` must fail the same check
    leaves, treedef = tree_flatten(tree_map(lambda x: x[0], state["params"]))
    first = {k: v[0, 0] for k, v in batches.items()}
    del state, global_delta, args
    l_t, g_t = loss_and_grads(ref_cfg.replace(dtype="float32"), leaves, treedef, first,
                                f32=True)
    l_r, g_r = loss_and_grads(ref_cfg, leaves, treedef, first)
    l_k, g_k = loss_and_grads(cfg, leaves, treedef, first)
    scale, ratio = grad_gaps(g_k, g_r, g_t)
    print(f"launch[step]: its first local step, kernel / reference / f32 path: loss {l_k:.6f} "
          f"/ {l_r:.6f} / {l_t:.6f}; gradient |g_k - g_r| / |g_r| {_tree_gap(g_k, g_r):.4g}, "
          f"against f32 {_tree_gap(g_k, g_t):.4g} / {_tree_gap(g_r, g_t):.4g} (printed "
          f"only); per leaf: scale drift {scale:.4g} (tol {GRAD_SCALE_TOL:.4g}), error "
          f"against f32 over the reference path's {ratio:.4g} (tol {GRAD_RATIO_TOL:.4g})",
          flush=True)
    assert scale <= GRAD_SCALE_TOL and ratio <= GRAD_RATIO_TOL, (scale, ratio)
    del g_k
    for name, plants in GRAD_FAULTS.items():
        kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in plants]
        try:
            for mod, attr, wrap in plants:
                setattr(mod, attr, wrap(getattr(mod, attr)))
            _, g_f = loss_and_grads(cfg, leaves, treedef, first)
        finally:
            for mod, attr, fn in kept:
                setattr(mod, attr, fn)
        f_scale, f_ratio = grad_gaps(g_f, g_r, g_t)
        print(f"launch[step]: planted fault {name}: scale drift {f_scale:.4g}, error ratio "
              f"{f_ratio:.4g}", flush=True)
        assert f_scale > GRAD_SCALE_TOL or f_ratio > GRAD_RATIO_TOL, (name, f_scale, f_ratio)
        del g_f
    print(f"launch[step]: the check fails each of the {len(GRAD_FAULTS)} planted faults; "
          f"phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    del batches, leaves, g_r, g_t
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
    under ``SCRATCH``), the ``clients:1`` and ``pods:1x1x1`` meshes, and the
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


def _tp_rank(rank, port, answers, teachers, want):
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
    greedy tokens it changes."""
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
                out[arch] = dict(
                    logits=outs, tokens=tokens, faulty=faulty, prefill_s=prefill_s,
                    step_s=step_s, wall_p=wall_p, busy_us=busy_us, launches=launches,
                    census_p=census_p, census_d=census_d, peak_p=peak_p, peak_d=peak_d,
                    token=_host(tok), parts=np.diff(marks).tolist())
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
    from the sound run's.  Returns rank 0's launches per arch."""
    from repro_torch.launch.mesh import parse_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    wants, teachers, floors, counted = {}, {}, {}, {}

    def prepare():  # while the ranks start
        nonlocal t_spawn
        for arch in TP_ARCHS:
            wants[arch], teachers[arch], floors[arch] = _tp_whole(arch)
        spec = parse_mesh(TP_SERVE["mesh"])
        for arch in TP_ARCHS:
            for shape in _tp_shapes():
                rec = dryrun.run_one(arch, shape, save=False, verbose=False, mesh=spec)
                assert rec["serve_layout"] == "tensor_parallel", rec["serve_layout"]
                counted[arch, shape.kind] = rec
        t_spawn = time.perf_counter()
        return teachers, wants

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
                  f"{r['parts'][2]:.1f}", flush=True)
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
    print(f"tp serve: phase {time.perf_counter() - t_phase:.1f}s (the whole models and the "
          f"dry run's counts {t_spawn - t_phase:.1f}s while the two processes started, then "
          f"the two processes {time.perf_counter() - t_spawn:.1f}s)", flush=True)
    return {arch: got[0][arch]["launches"] for arch in TP_ARCHS}


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


def print_ptxas(source):
    """Registers, shared memory and spills of each kernel in ``source``, from
    the ``-Xptxas -v`` report the build keeps.  A spill fails the run: the
    tensor-core kernels' f32 accumulators are sized to fit their registers."""
    name = None
    for line in kernel_build.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)(?:I(\w+?)E*v)?", line)
        if m:
            args = re.findall(r"L[ib](\d+)", m.group(2) or "")
            name = f"{m.group(1)}<{', '.join(args)}>"
        elif name and ("registers" in line or "spill" in line):
            print(f"build[ptxas {name}]: {line.split(':', 1)[-1].strip()}", flush=True)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            assert not spills or spills.groups() == ("0", "0"), (name, line)


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

    rec = check_kernels()
    for k, r in check_update_c1().items():
        rec[k].update(r)
    ranges = time_ranges()
    rec["rmsnorm"] = check_rmsnorm()
    worst = check_flash()
    # the LM slice's gemma3-1b (H = 4 over KV = 1, D = 256; 4 full-attention
    # layers, 22 at window 512), then zamba2's shared attention at D = 80
    rec.update(time_flash(4, 1, 256, (None, 512), seed=13))
    for name, r in time_flash(32, 32, 80, (None,), seed=14).items():
        rec[name]["d80"] = r
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
    paths["train_step_gemma3_1b"] = launch_tooling_run()
    paths.update(scripts_run())
    mesh_paths, worst = mesh_run()
    paths.update(mesh_paths)
    paths.update(mesh_train_run())
    lap("phases 15-17")
    for arch, launches in tp_serve_run().items():
        paths["tp_serve_" + arch.replace("-", "_").replace(".", "_") + "_rank0"] = launches
    for arch, launches in tp_train_run().items():
        paths["tp_train_" + arch.replace("-", "_").replace(".", "_") + "_rank0"] = launches
    lap("phases 18-19")
    for k in ("reduce3", "update"):
        rec[k + "_range"] = {**ranges[k], "max_abs_err": worst[k]}

    def record(name, key, source, replaces):
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
