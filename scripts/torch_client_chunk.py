"""How the federation engine's client map groups its clients, on the card.

A vmapped convolution folds its clients into one grouped convolution, so a
client's gradient may depend on how many clients share the vmap; the mesh
engines split the cohort over ranks, and their histories are bitwise the
one-device history only if it does not.  This script measures, on one card
under ``cudnn.deterministic``, at RESNET9_CIFAR100 width (K' = 20 clients,
batch 50, 32x32 images, 100 classes):

- the gradient of ``cnn.loss_fn`` vmapped over the 20 clients: whole,
  as 2 vmaps of 10 and as 20 vmaps of 1, and under
  ``torch.func.vmap(chunk_size=c)`` for c in 1, 2, 5, 10 over 20 and over
  each half: which groupings agree bit for bit, and each one's time
  (CUDA events, mean of ``--reps`` calls after a warm-up);
- the ResNet round (``launch/profile_round.py``'s phase times, pfedsop,
  mean of rounds 1-2) with the engine's client map as it is (one client a
  chunk) and with ``whole_cohort_vmap`` (one vmap of the whole cohort, the
  map before it was chunked) swapped in, in turns whole, 1, 1, whole.

    PYTHONPATH=src python scripts/torch_client_chunk.py [--reps 5]
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100
from repro_torch.core.baselines import PFedSOP
from repro_torch.core.pfedsop import PFedSOPConfig
from repro_torch.data import FederatedData, dirichlet_partition, make_class_conditional_images
from repro_torch.fl import engine
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.pfedsop_update import ops
from repro_torch.launch import profile_round
from repro_torch.models import cnn
from repro_torch.utils.pytree import tree_leaves, tree_map

K, BATCH = 20, 50


def _grad_fn(cfg):
    return torch.func.grad(lambda p, b: cnn.loss_fn(p, cfg, b))


def grads(cfg, params, batch, lo, hi, chunk=None):
    """Clients lo..hi-1's gradients, one vmap (in chunks of ``chunk``)."""
    sub = lambda t: tree_map(lambda x: x[lo:hi], t)
    return torch.func.vmap(_grad_fn(cfg), chunk_size=chunk)(sub(params), sub(batch))


def whole_cohort_vmap(fn, states, broadcast, rest):
    """The engine's client map as one vmap over the whole cohort."""
    return torch.func.vmap(fn, in_dims=(0, None, 0))(states, broadcast, rest)


def joined(parts):
    return [torch.cat(xs) for xs in zip(*(tree_leaves(p) for p in parts))]


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_client_chunk: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg = RESNET9_CIFAR100
    g = torch.Generator().manual_seed(0)
    one = cnn.init_params(g, cfg, device="cuda")
    params = tree_map(lambda x: (x + 0.01 * torch.randn((K,) + x.shape, generator=g).to(x.device)),
                      one)
    images, labels = make_class_conditional_images(K * BATCH, cfg.n_classes, cfg.cnn_image_size,
                                                   seed=0)
    batch = {"images": torch.from_numpy(images).reshape(K, BATCH, *images.shape[1:]).cuda(),
             "labels": torch.from_numpy(labels).reshape(K, BATCH).cuda()}

    whole = tree_leaves(grads(cfg, params, batch, 0, K))
    halves = joined([grads(cfg, params, batch, 0, K // 2), grads(cfg, params, batch, K // 2, K)])
    singles = joined([grads(cfg, params, batch, i, i + 1) for i in range(K)])
    print(f"client_chunk: vmap of {K} vs 2 x {K // 2}: bitwise {same(whole, halves)}; "
          f"vs {K} x 1: bitwise {same(whole, singles)}", flush=True)
    for c in (1, 2, 5, 10):
        full = tree_leaves(grads(cfg, params, batch, 0, K, c))
        split = joined([grads(cfg, params, batch, 0, K // 2, c),
                        grads(cfg, params, batch, K // 2, K, c)])
        print(f"client_chunk: chunk_size={c} over {K} vs over 2 x {K // 2}: bitwise "
              f"{same(full, split)}; vs {K} x 1: bitwise {same(full, singles)}", flush=True)
    times = {"whole": timed(lambda: grads(cfg, params, batch, 0, K), args.reps),
             "2x10": timed(lambda: [grads(cfg, params, batch, i, i + K // 2)
                                    for i in (0, K // 2)], args.reps)}
    for c in (1, 2, 5, 10):
        times[f"chunk_size={c}"] = timed(lambda c=c: grads(cfg, params, batch, 0, K, c), args.reps)
    print("client_chunk: gradient of the 20 clients, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()), flush=True)

    kernel_build.build(ops.SOURCE)
    ops.build()
    images, labels = make_class_conditional_images(20_000, cfg.n_classes, cfg.cnn_image_size,
                                                   seed=0)
    data = FederatedData.from_partition(
        images, labels, dirichlet_partition(labels, 100, 0.07, seed=0), seed=0)
    chunked = engine._run_vmap
    for label, run in (("whole", whole_cohort_vmap), ("chunk_size=1", chunked),
                       ("chunk_size=1", chunked), ("whole", whole_cohort_vmap)):
        engine._run_vmap = run
        try:
            ph = profile_round.phase_times(PFedSOP(cfg=PFedSOPConfig(eta1=0.05, eta2=0.05)),
                                           data, cfg, 3)
        finally:
            engine._run_vmap = chunked
        print(f"client_chunk: client map {label}: pfedsop phases (ms, mean of rounds 1-2): "
              + ", ".join(f"{k}={1e3 * v:.3f}" for k, v in ph.items()), flush=True)


if __name__ == "__main__":
    main()
