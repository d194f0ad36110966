"""Where a federated round's time goes on the card.

Runs the main-path slice (``Federation`` at RESNET9_CIFAR100 width, 32x32
images, 100 classes, 20,000 samples, K = 100, participation 0.2, batch
50, Dir(0.07), seed 0) for each method and reports, per round after the
first:

- phase times on the host clock with a device synchronize around each
  phase: gather, round-start update (pfedsop's kernel pair), the client
  phase's remainder (vmapped local SGD), eval, aggregate, scatter, and
  the host-side rest (sampling, host->device copies of the batches);
- one round under ``torch.profiler`` (no synchronizes added): device
  busy time (the union of the device events' intervals), the idle share
  of the round's wall time, and the kernels that take the most device
  time (their summed self times, which may double count).

  PYTHONPATH=src python -m repro_torch.launch.profile_round [--rounds 3]
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch
from torch.autograd import DeviceType

from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100
from repro_torch.core.baselines import FedAvg, PFedSOP
from repro_torch.core.pfedsop import PFedSOPConfig
from repro_torch.data import FederatedData, dirichlet_partition, make_class_conditional_images
from repro_torch.fl import Federation, FLRunConfig, masked_accuracy
from repro_torch.kernels.pfedsop_update import ops
from repro_torch.models import cnn


def _timed(times, name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[name] += time.perf_counter() - t0
        return out

    return wrapper


def _federation(method, data, cfg, rounds):
    params = cnn.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    return Federation(
        method, lambda p, b: cnn.loss_fn(p, cfg, b),
        masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"])), params, data,
        FLRunConfig(n_clients=data.n_clients, participation=0.2, rounds=rounds,
                    batch=50, seed=0), device="cuda")


def phase_times(method, data, cfg, rounds):
    """Mean per-phase seconds over rounds 1.. (round 0 warms cuDNN)."""
    fed = _federation(method, data, cfg, rounds)
    fed.run_round()
    times = collections.Counter()
    fed.store.gather = _timed(times, "gather", fed.store.gather)
    fed.store.scatter = _timed(times, "scatter", fed.store.scatter)
    fed.programs.eval = _timed(times, "eval", fed.programs.eval)
    fed.programs.aggregate = _timed(times, "aggregate", fed.programs.aggregate)
    client = _timed(times, "client", fed.programs.client)
    fed.programs.client = client
    update = ops.pfedsop_update_batched
    ops.pfedsop_update_batched = _timed(times, "round_start_update", update)
    try:
        wall = 0.0
        for _ in range(rounds - 1):
            t0 = time.perf_counter()
            fed.run_round()
            wall += time.perf_counter() - t0
    finally:
        ops.pfedsop_update_batched = update
    n = rounds - 1
    out = {k: v / n for k, v in times.items()}
    out["client_local_sgd"] = out.pop("client") - out.get("round_start_update", 0.0)
    out["host_rest"] = wall / n - sum(out.values())
    out["round"] = wall / n
    return out


def device_profile(method, data, cfg):
    fed = _federation(method, data, cfg, 2)
    fed.run_round()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fed.run_round()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    # busy = the union of the device events' intervals (us), so an event
    # the profiler reports twice, or two that overlap, count once
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy_ms = busy_us / 1e3
    return wall * 1e3, busy_ms, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = RESNET9_CIFAR100
    images, labels = make_class_conditional_images(20_000, cfg.n_classes,
                                                   cfg.cnn_image_size, seed=0)
    data = FederatedData.from_partition(
        images, labels, dirichlet_partition(labels, 100, 0.07, seed=0), seed=0)
    print(f"T={data.local_iters(50)} local steps, test rows per client "
          f"{data.test_idx.shape[1]}, train rows {data.train_idx.shape[1]}")
    methods = {"pfedsop": lambda: PFedSOP(cfg=PFedSOPConfig(eta1=0.05, eta2=0.05)),
               "fedavg": lambda: FedAvg(lr=0.05)}
    for name, make in methods.items():
        ph = phase_times(make(), data, cfg, args.rounds)
        print(f"[{name}] phases (ms, mean of {args.rounds - 1} rounds, "
              "synchronized): " + ", ".join(f"{k}={1e3 * v:.3f}" for k, v in ph.items()))
        wall_ms, busy_ms, rows = device_profile(make(), data, cfg)
        if not rows:
            print(f"[{name}] profiled round: wall {wall_ms:.3f} ms, device time "
                  "not measured (the profiler recorded no CUDA kernel)")
            continue
        print(f"[{name}] profiled round: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
              f"summed kernel self time {sum(r[1] for r in rows):.3f} ms")
        for key, ms, count in rows[:8]:
            print(f"[{name}]   {ms:9.3f} ms  x{count:<5d} {key[:110]}")


if __name__ == "__main__":
    main()
