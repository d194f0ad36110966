"""Where a round's time goes on each cohort store, on the card.

Runs pfedsop on ``chip_smoke.py``'s fleet (``Federation`` at
RESNET9_CIFAR100 width, K = 1,000 clients, participation 0.02 so K' = 20,
batch 50, T = 4, seed 0; client i holds the 50 images from 50 i mod
19,950) on the device, host and mmap stores, traced at obs level
``phase``, and reports per round after the first the synchronized phase
times: ``gather`` (on the host stores: the deferred write-back of the last
round's rows, the rows' fancy-index into pinned buffers and the copy to
the card), ``client``, ``eval``, ``aggregate`` and ``scatter`` (its
submit time; the copies to the host overlap what follows).

Then the copies themselves at one leaf of the round's cohort, K' rows of
N f32 out of a (K, N) array: host to device through a pinned staging
buffer (the store's path) against a pageable copy of the fancy-indexed
rows, device to host into a pinned buffer (the store's path) against
``.cpu()``, and the numpy write of the rows back.

  PYTHONPATH=src python -m repro_torch.launch.profile_store [--rounds 4]

The mmap store's files (10 GB) and the traces go to a temporary directory,
removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100
from repro_torch.core.baselines import PFedSOP
from repro_torch.core.pfedsop import PFedSOPConfig
from repro_torch.data import FederatedData, make_class_conditional_images
from repro_torch.fl import Federation, FLRunConfig, StoreConfig, masked_accuracy
from repro_torch.models import cnn
from repro_torch.obs import ObsConfig, read_events
from repro_torch.utils.pytree import FlatLayout

FLEET_K = 1000


def fleet_data(images, labels, k: int = FLEET_K) -> FederatedData:
    """Client i holds the 50 samples from 50 i mod 19,950 (``repro``'s
    cohort-store bench builds its fleet so; a Dir(0.07) split over 1,000
    clients would leave clients empty)."""
    parts = [np.arange((50 * i) % 19_950, (50 * i) % 19_950 + 50) for i in range(k)]
    return FederatedData.from_partition(images, labels, parts, seed=0)


def phase_times(data, store, rounds, trace_dir):
    """Mean synchronized phase seconds over rounds 1.. (round 0 warms cuDNN)."""
    cfg = RESNET9_CIFAR100
    params = cnn.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    fed = Federation(
        PFedSOP(cfg=PFedSOPConfig(eta1=0.05, eta2=0.05)), lambda p, b: cnn.loss_fn(p, cfg, b),
        masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"])), params, data,
        FLRunConfig(n_clients=data.n_clients, participation=0.02, rounds=rounds, batch=50,
                    local_iters=4, seed=0, store=store,
                    obs=ObsConfig(trace_dir=str(trace_dir), level="phase")),
        device="cuda")
    hist = fed.run()
    per = {}
    for e in read_events(trace_dir):
        if e.get("k") == "span" and "dur" in e and e["name"] != "round":
            per.setdefault(e["name"], []).append(e["dur"] / 1e6)
    out = {k: float(np.mean(v[1:])) for k, v in per.items()}
    out["round"] = float(np.mean(hist["round_time"][1:]))
    return out


def _ms(fn, n=5):
    """Mean host ms of ``fn`` (which ends in a synchronize), after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e3 * (time.perf_counter() - t0) / n


def copy_times(k: int, rows: int, n: int):
    """ms of each copy path for ``rows`` rows of one (k, n) f32 leaf."""
    a = np.ones((k, n), np.float32)
    ids = np.random.RandomState(0).choice(k, rows, replace=False)
    dev = torch.randn(rows, n, device="cuda")
    host = np.ones((rows, n), np.float32)

    def h2d_pinned():
        stage = torch.empty((rows, n), dtype=torch.float32, pin_memory=True)
        np.take(a, ids, axis=0, out=stage.numpy(), mode="wrap")
        stage.to("cuda", non_blocking=True)
        torch.cuda.synchronize()

    def h2d_pageable():
        torch.from_numpy(a[ids]).to("cuda")
        torch.cuda.synchronize()

    def d2h_pinned():
        torch.empty((rows, n), dtype=torch.float32, pin_memory=True).copy_(dev, non_blocking=True)
        torch.cuda.synchronize()

    def d2h_pageable():
        dev.cpu()

    def write_back():
        a[ids] = host

    return {"h2d pinned (take into the stage + copy)": _ms(h2d_pinned),
            "h2d pageable (fancy-index + .to)": _ms(h2d_pageable),
            "d2h pinned": _ms(d2h_pinned), "d2h pageable (.cpu)": _ms(d2h_pageable),
            "numpy write-back": _ms(write_back)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = RESNET9_CIFAR100
    images, labels = make_class_conditional_images(20_000, cfg.n_classes,
                                                   cfg.cnn_image_size, seed=0)
    data = fleet_data(images, labels)
    scratch = Path(tempfile.mkdtemp(prefix="profile_store_"))
    try:
        mmap_dir = str(scratch / "mmap")
        stores = {"device": "device",
                  "host": StoreConfig(kind="host", mmap_threshold_bytes=0),
                  "mmap": StoreConfig(kind="mmap", mmap_dir=mmap_dir)}
        for name, store in stores.items():
            ph = phase_times(data, store, args.rounds, scratch / f"trace_{name}")
            print(f"[{name}] phases (ms, mean of rounds 1-{args.rounds - 1}, synchronized): "
                  + ", ".join(f"{k}={1e3 * v:.3f}" for k, v in ph.items()), flush=True)
            shutil.rmtree(mmap_dir, ignore_errors=True)
        n = FlatLayout(cnn.init_params(torch.Generator().manual_seed(0), cfg,
                                       device="cpu")).size
        for label, ms in copy_times(FLEET_K, 20, n).items():
            print(f"[copy] {label}: {ms:.3f} ms for 20 rows of {n} f32 "
                  f"({20 * n * 4 / ms / 1e6:.2f} GB/s)", flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    main()
