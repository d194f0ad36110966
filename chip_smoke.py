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
                  path's C = 1, N = 999,826,048 (gemma3-1b); rmsnorm (K4)
                  and flash_gqa forward / dq / dk-dv (K5-K7) at the LM
                  slice's shapes (B = 2, S = 2048, D = 256), G = 1 and 4,
                  window on and off, softcap on and off, f32 and bf16, plus
                  bf16 at D = 64 and 128, a ragged S = 1,000 and S = 40 (bf16
                  K5-K7 run on the tensor cores, ``flash_gqa_sm90.cu``;
                  K6's dq and K7's dk/dv held bitwise across two launches,
                  in f32 before their final rounding within half an ulp,
                  and K7's sum pass bitwise against its plain version); the
                  flash cases at 8 seeds; K6 + K7 timed together beside
                  SDPA's backward.  Device times (torch.profiler; host time
                  and an L2 flush before each call left out) beside
                  the bound (bytes over 3.35 TB/s, or operations over the
                  type's peak), the plain version's time and, where one
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
                  bit.

Prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import functools
import json
import math
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
    masked_accuracy,
)
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.kernels.flash_gqa import grid  # noqa: E402
from repro_torch.kernels.flash_gqa import ops as flash_ops  # noqa: E402
from repro_torch.kernels.pfedsop_update import ops  # noqa: E402
from repro_torch.kernels.pfedsop_update.ref import coeff_from_sums, gompertz_beta  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.launch import train_lm_pfedsop as lm_driver  # noqa: E402
from repro_torch.launch.train_federated import METHOD_NAMES, build_method  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import ObsConfig, read_events  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
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


def bound(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    elems = MAIN_C * MAIN_N
    b1, by1 = bound(di.nbytes + dg.nbytes + partials.nbytes, 6 * elems)
    b2, by2 = bound(3 * x.nbytes + dg.nbytes + beta.nbytes + ec.nbytes, 5 * elems)
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
    b1, _ = bound(di.nbytes + dg.nbytes + ops.n_tiles(LM_N) * 12, 6 * LM_N)
    b2, _ = bound(3 * x.nbytes + dg.nbytes + 8, 5 * LM_N)
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
    b, by = bound(2 * x.nbytes + sc.nbytes, 4 * x.numel(), BF16_OPS_PER_S)
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
    are partial, and at S = 40 (D = 64, window 16), shorter than one tile.
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
    cases = [  # (G, window, softcap, dtype, S, D)
        (4, 512, None, bf16, 2048, 256), (4, None, None, bf16, 2048, 256),
        (1, 512, 50.0, bf16, 2048, 256), (4, None, 50.0, f32, 2048, 256),
        (1, 512, None, f32, 2048, 256),
        (4, 512, None, bf16, 2048, 64), (4, None, None, bf16, 2048, 64),
        (4, 512, None, bf16, 2048, 128), (4, None, None, bf16, 2048, 128),
        (4, 512, None, bf16, 1000, 256), (4, 16, None, bf16, 40, 64)]
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        for gq, window, cap, dtype, s, d in cases:
            q, k, v, do = _attention(g, 4, 4 // gq, dtype, s=s, d=d)
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
            label = (f"seed={seed} G={gq} window={window} softcap={cap} {str(dtype)[6:]} "
                     f"S={s} D={d}")
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

    # K7's sum pass at the slice's shape: f32 partials (B, S, H, D) -> bf16
    pk, pv = (_randn(g, 2, 2048, 4, 256) for _ in range(2))
    got = flash_ops.flash_bwd_dkv_sum(pk, pv, 1)
    want = flash_ops.flash_bwd_dkv_sum_plain(pk, pv, 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b), "sum pass differs from its plain version"
        worst["flash_bwd_dkv_sum"] = max(worst["flash_bwd_dkv_sum"],
                                         (a.float() - b.float()).abs().max().item())
    print("kernels[flash dk/dv sum pass (2, 2048, 4, 256) f32 -> bf16]: bitwise equal to "
          "its plain version", flush=True)
    return worst


def time_flash(worst):
    """Times at the LM slice's shapes, bf16, G = 4: the records at a
    full-attention layer (4 of gemma3-1b's 26, where one PyTorch call,
    ``F.scaled_dot_product_attention``, computes the same function), and
    the 512-window layer (the other 22) printed beside them, and K6 + K7
    timed as one backward beside SDPA's.  Bounds count the visible (query,
    key) pairs: 4D flops each forward, 6D for the dq pass (scores, dO v^T,
    dq), 8D for the dk/dv pass, at the bf16 peak."""
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, do = _attention(g, 4, 1, torch.bfloat16)
    b, s, h, d = q.shape
    recs = {}
    for window in (None, 512):
        out, lse = flash_ops.flash_fwd(q, k, v, window=window)
        delta = flash_ops.row_delta(do, out)
        pairs = b * h * grid.attention_pairs(s, window)
        io = q.nbytes + k.nbytes + v.nbytes
        rows = lse.nbytes
        fns = {
            "flash_fwd": (lambda: flash_ops.flash_fwd(q, k, v, window=window),
                          lambda: flash_ops.flash_fwd_plain(q, k, v, window=window),
                          io + out.nbytes + rows, 4 * d * pairs),
            "flash_bwd_dq": (
                lambda: flash_ops.flash_bwd_dq(q, k, v, do, lse, delta, window=window),
                lambda: flash_ops.flash_bwd_dq_plain(q, k, v, do, lse, delta, window=window),
                io + 2 * do.nbytes + 2 * rows, 6 * d * pairs),
            "flash_bwd_dkv": (
                lambda: flash_ops.flash_bwd_dkv(q, k, v, do, lse, delta, window=window),
                lambda: flash_ops.flash_bwd_dkv_plain(q, k, v, do, lse, delta, window=window),
                io + do.nbytes + 2 * rows + k.nbytes + v.nbytes, 8 * d * pairs),
        }
        for name, (kern, plain, nbytes, nops) in fns.items():
            bnd, by = bound(nbytes, nops, BF16_OPS_PER_S)
            # K7's time includes its sum pass over the f32 head partials
            r = dict(ms=device_ms(kern), plain_ms=device_ms(plain, calls=5, warmup=1),
                     bound_ms=bnd, bound_by=by)
            _print_time(f"{name} window={window} B={b} S={s} H={h} KV=1 D={d} bf16", r)
            if window is None:
                recs[name] = r
            else:
                recs[name]["window512"] = r

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
    print(f"kernels[time sdpa full-attention bf16]: forward "
          f"{recs['flash_fwd']['library_ms']:.4f} ms, backward (dq, dk, dv) {bwd:.4f} ms",
          flush=True)
    delta = flash_ops.row_delta(do, want)
    pair = device_ms(lambda: (flash_ops.flash_bwd_dq(q, k, v, do, lse, delta),
                              flash_ops.flash_bwd_dkv(q, k, v, do, lse, delta)))
    recs["flash_bwd_dq"]["with_dkv_ms"] = pair
    print(f"kernels[time K6 + K7 full-attention bf16]: {pair:.4f} ms, SDPA's backward "
          f"{bwd:.4f} ms ({pair / bwd:.2f}x)", flush=True)

    # K7's sum pass alone: reads G f32 partials of dk and of dv, writes both
    pk, pv = (torch.empty((b, s, h, d), device="cuda") for _ in range(2))
    pk.normal_(generator=g)
    pv.normal_(generator=g)
    outs = flash_ops.flash_bwd_dkv_sum(pk, pv, 1)
    bnd, by = bound(pk.nbytes + pv.nbytes + 2 * outs[0].nbytes, 2 * (h - 1) * outs[0].numel(),
                    F32_OPS_PER_S)
    recs["flash_bwd_dkv_sum"] = dict(
        ms=device_ms(lambda: flash_ops.flash_bwd_dkv_sum(pk, pv, 1)),
        plain_ms=device_ms(lambda: flash_ops.flash_bwd_dkv_sum_plain(pk, pv, 1)),
        bound_ms=bnd, bound_by=by, library_ms=None)
    _print_time(f"flash_bwd_dkv_sum B={b} S={s} H={h} KV=1 D={d} f32 -> bf16",
                recs["flash_bwd_dkv_sum"])
    for name in recs:
        recs[name]["max_abs_err"] = worst[name]
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
def resnet_data():
    cfg = RESNET9_CIFAR100  # 32x32, 100 classes, (64, 128, 256) widths
    t0 = time.perf_counter()
    images, labels = make_class_conditional_images(20_000, cfg.n_classes,
                                                   cfg.cnn_image_size, seed=0)
    parts = dirichlet_partition(labels, 100, 0.07, seed=0)
    data = FederatedData.from_partition(images, labels, parts, seed=0)
    print(f"slice: data {time.perf_counter() - t0:.1f}s", flush=True)
    return data


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


def resnet_driver(method, rounds, mode="sync", async_cfg=None, **kw):
    """A driver of the ResNet slice (its width, data and sampling) on the card."""
    cfg, data = RESNET9_CIFAR100, resnet_data()
    run_cfg = FLRunConfig(n_clients=data.n_clients, participation=0.2, batch=50,
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

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _, h_p, _, wall_p = _async_run()
        torch.cuda.synchronize()
    assert h_p["loss"] == h["loss"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:  # the union of the device events' intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    assert busy_us > 0, "the profiler recorded no device event"
    print(f"async profiled: wall {wall_p * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / 1e3 / (wall_p * 1e3):.4f}", flush=True)
    return launches, h


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
    kernel_build.build(ops.SOURCE, rms_ops.SOURCE, flash_ops.SOURCE, flash_ops.SM90_SOURCE)
    for mod in (ops, rms_ops, flash_ops):
        mod.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    print_ptxas(flash_ops.SM90_SOURCE)

    rec = check_kernels()
    for k, r in check_update_c1().items():
        rec[k].update(r)
    rec["rmsnorm"] = check_rmsnorm()
    rec.update(time_flash(check_flash()))
    l2_flush.cache_clear()  # the timing phases are over: free the flush buffer
    torch.cuda.empty_cache()
    small_parity()
    lm_small_parity()
    resnet = slice_run()
    lm = lm_slice()
    methods = methods_run()
    torch.backends.cudnn.deterministic = True  # the bitwise phases below
    sync_vs_async()
    hetero, hist = async_run()
    async_resume(hist)
    shutil.rmtree(SCRATCH)

    def record(name, key, source, replaces):
        r = dict(rec[key])
        r.setdefault("library_ms", None)
        launches = lm[key] + resnet[key] + methods[key] + hetero[key]
        extra = ({"launches_by_path": {"resnet9": resnet[key], "lm_gemma3_1b": lm[key],
                                       "resnet9_methods": methods[key],
                                       "resnet9_async": hetero[key]}}
                 if resnet[key] else {})
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **r, **extra}

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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
