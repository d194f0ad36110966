"""Dev smoke of the PyTorch port: tiny federation, pFedSOP vs FedAvg, a few
rounds.

Counterpart of ``scripts/smoke_fl.py``; runs on the card unless given
``--device cpu``.

  PYTHONPATH=src python scripts/torch_smoke_fl.py [--device cpu]
"""
import argparse
import math

import torch

from repro_torch.configs.resnet_cifar import SMALL_CNN
from repro_torch.core.baselines import METHODS
from repro_torch.data import FederatedData, dirichlet_partition, make_class_conditional_images
from repro_torch.fl import Federation, FLRunConfig, masked_accuracy
from repro_torch.models import cnn
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SMALL_CNN
    images, labels = make_class_conditional_images(2000, cfg.n_classes, cfg.cnn_image_size, seed=0)
    parts = dirichlet_partition(labels, 10, alpha=0.3, seed=0)
    data = FederatedData.from_partition(images, labels, parts, seed=0)

    loss = lambda p, b: cnn.loss_fn(p, cfg, b)  # noqa: E731
    acc = masked_accuracy(lambda p, t: cnn.apply(p, cfg, t["images"]))
    params = cnn.init_params(torch.Generator().manual_seed(0), cfg, device=dev)

    run_cfg = FLRunConfig(n_clients=10, participation=0.4, rounds=args.rounds, batch=20, seed=0)
    hists = {}
    for name in ["pfedsop", "fedavg"]:
        method = METHODS[name]()
        fed = Federation(method, loss, acc, params, data, run_cfg, device=dev)
        hist = fed.run(verbose=True)
        print(name, "mean_best_acc", hist["mean_best_acc"], flush=True)
        assert math.isfinite(hist["loss"][-1])
        hists[name] = hist
    return hists


if __name__ == "__main__":
    main()
