"""Quickstart (PyTorch port): the pFedSOP optimizer on a 2-client toy problem.

Counterpart of ``examples/quickstart.py``.  Shows the paper's three moving
parts:
  1. Gompertz-weighted personalized aggregation of local/global updates
  2. Sherman-Morrison second-order step on the regularized FIM
  3. local SGD + server aggregation of gradient updates

On the card the round-start update (1 + 2) is the fused kernel pair K1/K2
at one client and N = 4 parameters, far below one 4,096-element tile.  Runs
on the card unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import pfedsop as pf
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_stack

# two clients with different optima - a miniature "heterogeneous federation"
TARGETS = [2.0, -1.0]


def make_loss(target):
    def loss_fn(params, batch):
        noise = batch["noise"]  # (batch_size,) pseudo-noise, keeps SGD stochastic
        err = params["w"][None, :] - target + 0.01 * noise[:, None]
        return 0.5 * torch.mean(err**2)
    return loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = pf.PFedSOPConfig(eta1=0.8, eta2=0.2, rho=1.0, lam=1.0)
    params = {"w": torch.zeros((4,), device=dev)}
    states = [pf.init_client_state(params) for _ in TARGETS]
    global_delta = {"w": torch.zeros((4,), device=dev)}
    has_global = torch.zeros((), dtype=torch.bool, device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"{'round':>5} {'client0 w[0]':>12} {'client1 w[0]':>12} {'beta0':>7}")
    for t in range(25):
        deltas, metrics = [], []
        for i, target in enumerate(TARGETS):
            # 5 local SGD iterations of 8 noise samples
            batches = {"noise": torch.randn((5, 8), generator=gen, device=dev)}
            states[i], delta, m = pf.tree_client_round(
                make_loss(target), states[i], global_delta, has_global, batches, cfg)
            deltas.append(delta)
            metrics.append(m)
        # server: Eq. 13
        global_delta = pf.server_aggregate(tree_stack(deltas))
        has_global = torch.ones_like(has_global)
        if t % 5 == 0 or t == 24:
            print(f"{t:>5} {float(states[0].params['w'][0]):>12.4f} "
                  f"{float(states[1].params['w'][0]):>12.4f} "
                  f"{float(metrics[0]['beta']):>7.3f}")

    for i, target in enumerate(TARGETS):
        err = float((states[i].params["w"] - target).abs().max())
        print(f"client {i}: |w - {target}| = {err:.4f} (personalized, not the global mean)")
        assert err < 0.2, "personalization failed"
    print("OK: each client converged to ITS OWN optimum under collaboration.")
    return states


if __name__ == "__main__":
    main()
