#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

  1. environment  card name and power limit (nvidia-smi), torch/CUDA
                  versions, compute capability 9.0 asserted;
  2. build        the CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
  3. kernels      each kernel against its plain PyTorch version on the card
                  at the main-path shape (C = 20 clients, N = 1,249,956
                  ResNet-9 parameters, shared server delta) and at per-client
                  delta, C = 1, ragged N and bf16; times from CUDA events
                  beside the bound (bytes over 3.35 TB/s, or operations over
                  the f32 peak);
  4. small parity the port's federation on the card against the same run
                  on the CPU (plain kernel versions) on a small CNN;
  5. slice        the main path: ``Federation`` at RESNET9_CIFAR100 width,
                  32x32 images, 100 classes, 20,000 samples, K = 100,
                  participation 0.2, batch 50, Dir(0.07), seed 0 — 3 rounds
                  each of pfedsop and fedavg with the launch counters reset
                  just before, then 2 pfedsop rounds with the reference
                  update held against the kernel run.

Prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100, SMALL_CNN  # noqa: E402
from repro_torch.core.baselines import FedAvg, PFedSOP  # noqa: E402
from repro_torch.core.pfedsop import PFedSOPConfig  # noqa: E402
from repro_torch.data import (  # noqa: E402
    FederatedData,
    dirichlet_partition,
    make_class_conditional_images,
)
from repro_torch.fl import Federation, FLRunConfig, masked_accuracy  # noqa: E402
from repro_torch.kernels.pfedsop_update import ops  # noqa: E402
from repro_torch.kernels.pfedsop_update.ref import coeff_from_sums, gompertz_beta  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
MAIN_C, MAIN_N = 20, 1_249_956  # K' = 0.2 * 100 clients; RESNET9_CIFAR100 params
SOURCE = "src/repro_torch/kernels/pfedsop_update/csrc/pfedsop_update.cu"


def median_ms(fn, reps=30, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, nops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
            ms=median_ms(lambda: ops.reduce3_batched(di, dg)),
            plain_ms=median_ms(lambda: ops.reduce3_batched_plain(di, dg)),
            bound_ms=b1, bound_by=by1),
        "update": dict(
            ms=median_ms(lambda: ops.update_batched(x, di, dg, beta, ec)),
            plain_ms=median_ms(lambda: ops.update_batched_plain(x, di, dg, beta, ec)),
            bound_ms=b2, bound_by=by2),
    }
    for k, r in rec.items():
        r["max_abs_err"] = worst[k]
        print(f"kernels[time {k}]: C={MAIN_C} N={MAIN_N} f32 kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), kernel at {100 * r['bound_ms'] / r['ms']:.1f}% "
              "of bound", flush=True)
    return rec


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


def slice_run():
    cfg = RESNET9_CIFAR100  # 32x32, 100 classes, (64, 128, 256) widths
    t0 = time.perf_counter()
    images, labels = make_class_conditional_images(20_000, cfg.n_classes,
                                                   cfg.cnn_image_size, seed=0)
    parts = dirichlet_partition(labels, 100, 0.07, seed=0)
    data = FederatedData.from_partition(images, labels, parts, seed=0)
    print(f"slice: data {time.perf_counter() - t0:.1f}s", flush=True)
    kw = dict(participation=0.2, batch=50)
    pcfg = PFedSOPConfig(eta1=0.05, eta2=0.05)  # the driver's default lr

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    fed_k, h_k = federation(cfg, data, PFedSOP(cfg=pcfg), 3, "cuda", **kw)
    after_pfedsop = dict(ops.LAUNCHES)
    _, h_f = federation(cfg, data, FedAvg(lr=0.05), 3, "cuda", **kw)
    launches = dict(ops.LAUNCHES)
    assert fed_k.layout.size == MAIN_N and fed_k.kprime == MAIN_C
    assert after_pfedsop == {"reduce3": 3, "update": 3}, after_pfedsop
    assert launches == after_pfedsop, launches  # FedAvg launches nothing
    for name, h in (("pfedsop", h_k), ("fedavg", h_f)):
        assert all(math.isfinite(v) for v in h["loss"]), (name, h["loss"])
        for t in range(len(h["loss"])):
            print(f"slice[{name}] round {t}: loss={h['loss'][t]:.6f} "
                  f"acc={h['acc'][t]:.6f} round_time={h['round_time'][t]:.4f}s",
                  flush=True)

    _, h_r = federation(cfg, data, PFedSOP(cfg=pcfg), 2, "cuda",
                        update_impl="reference", **kw)
    assert dict(ops.LAUNCHES) == launches
    # kernel vs reference update: fp32 reduction order in beta/the step,
    # plus cuDNN's run-to-run order; acc may flip one prediction of the
    # smallest test set (>= 1 sample) of one of the 20 clients
    np.testing.assert_allclose(h_r["loss"], h_k["loss"][:2], rtol=1e-4)
    np.testing.assert_allclose(h_r["acc"], h_k["acc"][:2], atol=0.05)
    print(f"slice: reference update loss {h_r['loss']} acc {h_r['acc']}", flush=True)
    return launches


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
    ops.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    rec = check_kernels()
    small_parity()
    launches = slice_run()

    kernels = [
        {"name": "pfedsop_reduce3", "route": "cuda", "source": SOURCE,
         "replaces": "src/repro/kernels/pfedsop_update/kernel.py:132",
         "launches": launches["reduce3"], **rec["reduce3"], "library_ms": None},
        {"name": "pfedsop_update", "route": "cuda", "source": SOURCE,
         "replaces": "src/repro/kernels/pfedsop_update/kernel.py:163",
         "launches": launches["update"], **rec["update"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
