"""Where an LM client round's time goes on the card.

Runs one client of the LM slice (``train_lm_pfedsop``'s loop at the
slice ``chip_smoke.py`` runs: gemma3-1b, or ``--arch``, at full width,
batch 2, seq_len 2048, 2 local iterations, eta 0.1, seed 0) for one
warm-up round and one personalized round, and reports for the
personalized round:

- phase times on the host clock with a device synchronize around each
  phase: the round-start update (flatten, the C = 1 kernel pair,
  unflatten), the forward passes (``lm_loss``), and the rest of local
  SGD (backward with the recomputed forwards, the SGD update, the delta);
- one local step under ``torch.profiler`` (no synchronizes added):
  device busy time (the union of the device events' intervals), the idle
  share of the step's wall time, and device time grouped by kernel family
  (the port's kernels by name, cuBLAS matrix products, the rest), with the
  kernels each of the port's families ran (``flash_gqa.cu`` and
  ``flash_gqa_sm90.cu`` both name their dq pass ``dq_kernel``: the
  tensor-core one takes ``CUtensorMap`` arguments).

  PYTHONPATH=src python -m repro_torch.launch.profile_lm_step
  PYTHONPATH=src python -m repro_torch.launch.profile_lm_step --arch zamba2-2.7b
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import pfedsop as pf
from repro_torch.launch.train_lm_pfedsop import client_streams
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_stack

BATCH, SEQ_LEN, LOCAL_ITERS, ETA = 2, 2048, 2, 0.1

# kernel-name fragments -> family, first match wins
FAMILIES = [
    ("flash_fwd (K5)", ("fwd_kernel", "fwd_narrow_kernel", "fwd_tf32_kernel")),
    ("flash_bwd_dq (K6)", ("dq_kernel", "dq_narrow_kernel", "dq_tf32_kernel", "dq_wgmma_kernel",
                           "dq_tf32_wide_kernel")),
    ("flash_bwd_dkv (K7)", ("dkv_kernel", "dkv_narrow_kernel", "dkv_tf32_kernel",
                            "dkv_wgmma_kernel", "dkv_tf32_wide_kernel")),
    ("flash_bwd_dkv sum pass (K7)", ("dkv_sum_kernel",)),
    ("rmsnorm (K4)", ("rmsnorm_kernel",)),
    ("pfedsop reduce3/update (K1/K2)", ("reduce3_kernel", "update_kernel")),
    ("matmul (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "nvjet")),
]


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other (elementwise, softmax/CE, copies, reductions)"


def _timed(times, name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[name] += time.perf_counter() - t0
        return out
    return wrapper


def device_profile(fn):
    """(wall ms, device busy ms, {family: [ms, launches, kernel names]}) of
    one fn() call."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams = collections.defaultdict(lambda: [0.0, 0, set()])
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            fams[family(e.key)][0] += e.self_device_time_total / 1e3
            fams[family(e.key)][1] += e.count
            fams[family(e.key)][2].add(e.key)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return wall * 1e3, busy_us / 1e3, dict(fams)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="gemma3-1b")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config(args.arch)
    pcfg = pf.PFedSOPConfig(eta1=ETA, eta2=ETA)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    stream = client_streams(cfg, 1, BATCH, SEQ_LEN)[0]
    loss_fn = lambda p, b: tf.lm_loss(p, cfg, b)  # noqa: E731

    def batches():
        bs = [next(stream) for _ in range(LOCAL_ITERS)]
        return {k: torch.from_numpy(np.stack([b[k] for b in bs])).cuda() for k in bs[0]}

    state = pf.init_client_state(params)
    del params
    no_global = torch.zeros((), dtype=torch.bool, device="cuda")
    state, delta, _ = pf.tree_client_round(loss_fn, state, state.delta, no_global,
                                           batches(), pcfg)  # warm-up, not personalized
    global_delta = pf.server_aggregate(tree_stack([delta]))
    has_global = torch.ones_like(no_global)

    times = collections.Counter()
    personalize, lm_loss = pf.tree_personalize, tf.lm_loss
    pf.tree_personalize = _timed(times, "round_start_update", personalize)
    tf.lm_loss = _timed(times, "forward", lm_loss)
    try:
        b = batches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, delta, m = pf.tree_client_round(loss_fn, state, global_delta, has_global, b,
                                               pcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pf.tree_personalize, tf.lm_loss = personalize, lm_loss
    assert m["personalized"]
    phases = {k: 1e3 * v for k, v in times.items()}
    phases["backward_and_update"] = 1e3 * wall - sum(phases.values())
    print(f"[{cfg.name}] personalized client round (ms, synchronized, "
          f"{LOCAL_ITERS} local steps of B={BATCH} S={SEQ_LEN}): "
          + ", ".join(f"{k}={v:.3f}" for k, v in phases.items())
          + f", round={1e3 * wall:.3f}; loss {float(m['loss']):.6f} beta "
          f"{float(m['beta']):.6f}")

    one = {k: v[:1] for k, v in batches().items()}
    leaves = state.params
    wall_ms, busy_ms, fams = device_profile(
        lambda: sgd.tree_sgd_loop(loss_fn, leaves, one, ETA))
    total = sum(v[0] for v in fams.values())
    print(f"[{cfg.name}] profiled local step: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, summed kernel "
          f"self time {total:.3f} ms")
    for fam, (ms, count, names) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"[{cfg.name}]   {ms:10.3f} ms  {100 * ms / total:5.1f}%  x{count:<6d} {fam}")
        if "(K" in fam:
            for name in sorted(names):
                print(f"[{cfg.name}]       {name[:120]}")


if __name__ == "__main__":
    main()
