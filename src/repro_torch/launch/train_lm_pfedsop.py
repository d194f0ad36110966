"""Federated LM training with pFedSOP over the text archs, on the card.

Port of ``examples/train_lm_pfedsop.py`` with the same flags and loop:
simulated organizations, each with its own Markov token stream
(heterogeneity analog), train one decoder with pFedSOP, one client after
another; each round prints ``round {t} loss=... beta=...``.  Two flags
are the port's: ``--device`` (default ``cuda``) and ``--full``, which
takes the arch's full config (``get_config(arch)``) instead of the
reduced CPU-smoke variant the example uses.  Dense, MoE, SSM and hybrid
archs train; the modality-frontend archs are refused, as the example
refuses them.

  PYTHONPATH=src python -m repro_torch.launch.train_lm_pfedsop --device cpu --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train_lm_pfedsop --full --arch gemma3-1b \\
      --batch 2 --seq-len 2048 --local-iters 2 --rounds 3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import pfedsop as pf
from repro_torch.data import lm_batch_iterator, synthetic_lm_stream
from repro_torch.models import transformer as tf
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_stack


def launches_per_step(cfg):
    """Kernel launches of one local SGD step (forward + backward) of
    ``tf.lm_loss`` on the kernel path.  Per attention sublayer (``attn``,
    ``moe``, ``shared_attn``): the rmsnorms ln1, ln2 and (with qk-norm)
    q/k-norm and one flash forward, all launched again when
    ``remat="block"`` recomputes the sublayer in the backward, and one dq
    and one dk/dv pass (in bf16 with G > 1 query heads per KV head, also
    the dk/dv sum pass).  Per ``ssm`` sublayer: its ln1 (again under remat)
    and no flash kernel.  The final norm once."""
    n_attn = sum(s.kind != "ssm" for s in cfg.layers)
    n_ssm = cfg.n_layers - n_attn
    norms = 4 if cfg.use_qk_norm else 2
    again = 2 if cfg.remat == "block" else 1
    out = {"rmsnorm": (norms * n_attn + n_ssm) * again + 1}
    if n_attn:
        out.update(flash_fwd=n_attn * again, flash_bwd_dq=n_attn, flash_bwd_dkv=n_attn)
        if cfg.dtype == "bfloat16" and cfg.n_heads > cfg.n_kv_heads:
            out["flash_bwd_dkv_sum"] = n_attn
    return out


def client_streams(cfg, clients, batch, seq_len):
    """The example's per-client heterogeneous token streams."""
    return [lm_batch_iterator(
        synthetic_lm_stream(20_000, cfg.vocab_size, seed=100 + i, branch=3),
        batch, seq_len, seed=i) for i in range(clients)]


def train(cfg, params, pcfg, *, clients=4, rounds=10, local_iters=4, batch=4,
          seq_len=64, on_round=None):
    """The example's loop from ``params`` (a tree on its device; a caller
    that keeps no reference of its own lets it go after round 0).  Returns
    {"loss", "beta", "round_time"} per round (means over the clients) and
    the final client states.  ``on_round(t, loss, beta, seconds)`` is
    called after each round."""
    device = tree_leaves(params)[0].device
    iters = client_streams(cfg, clients, batch, seq_len)
    loss_fn = lambda p, b: tf.lm_loss(p, cfg, b)  # noqa: E731
    states = [pf.init_client_state(params) for _ in range(clients)]
    del params  # the states hold it until round 0 replaces it
    global_delta = states[0].delta  # zeros, as the example's tree_map(zeros_like)
    has_global = torch.zeros((), dtype=torch.bool, device=device)
    hist = {"loss": [], "beta": [], "round_time": []}
    for t in range(rounds):
        t0 = time.perf_counter()
        deltas, losses, betas = [], [], []
        for i in range(clients):
            bs = [next(iters[i]) for _ in range(local_iters)]
            batches = {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(device)
                       for k in bs[0]}
            states[i], delta, m = pf.tree_client_round(loss_fn, states[i], global_delta,
                                                       has_global, batches, pcfg)
            deltas.append(delta)
            losses.append(float(m["loss"]))
            betas.append(float(m["beta"]))
        global_delta = pf.server_aggregate(tree_stack(deltas))
        has_global = torch.ones_like(has_global)
        del deltas
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        hist["loss"].append(float(np.mean(losses)))
        hist["beta"].append(float(np.mean(betas)))
        hist["round_time"].append(dt)
        if on_round is not None:
            on_round(t, hist["loss"][-1], hist["beta"][-1], dt)
    return hist, states


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="granite-3-2b")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-iters", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-impl", default="auto", choices=["auto", "reference", "kernel"],
                    help="model kernel policy (rmsnorm/flash_gqa): the CUDA kernels "
                         "('kernel'; 'auto' on the card) or the plain reference")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config instead of the reduced smoke variant")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full).replace(kernel_impl=args.kernel_impl)
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch} needs a modality frontend; this example "
                         "covers the text archs (see serve_decode.py for the rest)")
    pcfg = pf.PFedSOPConfig(eta1=args.eta, eta2=args.eta, rho=1.0, lam=1.0)
    print(f"pFedSOP x {cfg.name}: {args.clients} clients, {args.rounds} rounds, "
          f"kernel_impl={cfg.kernel_impl}, device={dev}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tf.init_params(gen, cfg, device=dev)
    print(f"params: {sum(x.numel() for x in tree_leaves(params)) / 1e6:.2f}M")

    def log(t, loss, beta, dt):
        print(f"round {t:3d} loss={loss:.6f} beta={beta:.3f} ({dt:.1f}s)", flush=True)

    hist, _ = train(cfg, params, pcfg, clients=args.clients, rounds=args.rounds,
                    local_iters=args.local_iters, batch=args.batch,
                    seq_len=args.seq_len, on_round=log)
    assert np.isfinite(hist["loss"][-1])
    print("OK: federated LM training ran end-to-end "
          f"(final mean loss {hist['loss'][-1]:.4f})")


if __name__ == "__main__":
    main()
