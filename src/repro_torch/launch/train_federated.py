"""End-to-end driver of the port: the paper's experiment on the card.

The main-path subset of ``examples/train_federated.py`` with the same
defaults: heterogeneously partitioned synthetic image classification
across K clients with partial participation, pFedSOP against FedAvg
under identical initialization (pFedSOP Sec. V).

  PYTHONPATH=src python -m repro_torch.launch.train_federated            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train_federated \
      --model resnet9 --classes 100 --image-size 32 --paper-scale
  PYTHONPATH=src python -m repro_torch.launch.train_federated --device cpu --rounds 2
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100, SMALL_CNN
from repro_torch.core.baselines import FedAvg, PFedSOP
from repro_torch.core.pfedsop import PFedSOPConfig
from repro_torch.data import (
    FederatedData,
    dirichlet_partition,
    make_class_conditional_images,
    pathological_partition,
)
from repro_torch.fl import Federation, FLRunConfig, masked_accuracy
from repro_torch.models import cnn
from repro_torch.utils.device import resolve_device


def build_method(name, lr, args):
    if name == "pfedsop":
        return PFedSOP(cfg=PFedSOPConfig(eta1=lr, eta2=lr, rho=args.rho, lam=args.lam))
    return FedAvg(lr=lr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--methods", nargs="+", default=["pfedsop", "fedavg"],
                    choices=["pfedsop", "fedavg"])
    ap.add_argument("--partition", choices=["dirichlet", "pathological"],
                    default="dirichlet")
    ap.add_argument("--alpha", type=float, default=0.07)  # paper Dir(0.07)
    ap.add_argument("--shard-size", type=int, default=100)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--participation", type=float, default=0.2)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--batch", type=int, default=50)  # paper batch size
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--update-impl", default="",
                    choices=["", "auto", "reference", "kernel"],
                    help="pFedSOP round-start update impl: the CUDA kernel "
                         "pair ('kernel'; 'auto' on the card) or the plain "
                         "reference; '' defers to the method config")
    ap.add_argument("--model", choices=["small", "resnet9"], default="small")
    ap.add_argument("--paper-scale", action="store_true",
                    help="K=100 clients, 20%% participation, 100 rounds, "
                         "20000 samples")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)

    if args.update_impl and "pfedsop" not in args.methods:
        ap.error("--update-impl targets the pFedSOP round-start update; none "
                 f"of --methods {args.methods} has it")
    if args.paper_scale:
        args.clients, args.participation, args.rounds = 100, 0.2, 100
        args.samples = 20000
    if resolve_device(args.device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = SMALL_CNN if args.model == "small" else RESNET9_CIFAR100
    cfg = cfg.replace(n_classes=args.classes, cnn_image_size=args.image_size)

    print(f"dataset: {args.samples} samples, {args.classes} classes, "
          f"{args.partition} partition across {args.clients} clients")
    images, labels = make_class_conditional_images(
        args.samples, args.classes, args.image_size, seed=args.seed)
    if args.partition == "dirichlet":
        parts = dirichlet_partition(labels, args.clients, args.alpha, seed=args.seed)
    else:
        parts = pathological_partition(labels, args.clients, args.shard_size,
                                       seed=args.seed)
    data = FederatedData.from_partition(images, labels, parts, seed=args.seed)

    loss = lambda p, b: cnn.loss_fn(p, cfg, b)
    acc = masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"]))
    params = cnn.init_params(torch.Generator().manual_seed(args.seed), cfg,
                             device=args.device)  # same init for all
    run_cfg = FLRunConfig(n_clients=args.clients, participation=args.participation,
                          rounds=args.rounds, batch=args.batch, seed=args.seed)

    results = {}
    for name in args.methods:
        cfg_m = replace(run_cfg, update_impl=args.update_impl
                        if name == "pfedsop" else "")
        fed = Federation(build_method(name, args.lr, args), loss, acc, params,
                         data, cfg_m, device=args.device)
        hist = fed.run(verbose=True)
        results[name] = hist
        print(f"--> {name}: mean best acc {hist['mean_best_acc']:.4f}, "
              f"mean round time {np.mean(hist['round_time'][1:] or hist['round_time']):.3f}s")
    print(f"{'method':>14} {'best_acc':>9} {'final_loss':>11}")
    for name, h in results.items():
        print(f"{name:>14} {h['mean_best_acc']:>9.4f} {h['loss'][-1]:>11.4f}")
    return results


if __name__ == "__main__":
    main()
