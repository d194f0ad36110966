"""End-to-end driver of the port: the paper's experiment on the card.

``examples/train_federated.py``'s single-device surface with the same
defaults: heterogeneously partitioned synthetic image classification
across K clients with partial participation, pFedSOP against the
baselines (FedAvg, FedProx, the fine-tuning variants, Ditto, FedRep,
local-only, SCAFFOLD, FedExP) under identical initialization (pFedSOP
Sec. V), synchronous or asynchronous, with checkpoint/resume and
observability.

  PYTHONPATH=src python -m repro_torch.launch.train_federated            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train_federated \\
      --model resnet9 --classes 100 --image-size 32 --paper-scale
  PYTHONPATH=src python -m repro_torch.launch.train_federated --device cpu --rounds 2

  # asynchronous federation: heterogeneous client speeds, 30%% availability,
  # FedBuff-style buffered staleness-weighted updates
  PYTHONPATH=src python -m repro_torch.launch.train_federated --mode async \\
      --speed lognormal --availability 0.3 --buffer-size 4
  # replay a recorded device trace instead of the generative model
  PYTHONPATH=src python -m repro_torch.launch.train_federated --mode async \\
      --availability trace:examples/traces/device_trace_8.json

  # checkpoint every 5 server updates, resume an interrupted run, trace it
  PYTHONPATH=src python -m repro_torch.launch.train_federated --mode async \\
      --ckpt-every 5 --ckpt-dir experiments/ckpt/demo --trace-dir experiments/trace
  PYTHONPATH=src python -m repro_torch.launch.train_federated --mode async \\
      --ckpt-every 5 --ckpt-dir experiments/ckpt/demo --resume

Writes per-method histories to experiments/fl/<tag>.json.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.resnet_cifar import RESNET9_CIFAR100, SMALL_CNN
from repro_torch.core import baselines as bl
from repro_torch.core.pfedsop import PFedSOPConfig
from repro_torch.data import (
    FederatedData,
    dirichlet_partition,
    make_class_conditional_images,
    pathological_partition,
)
from repro_torch.fl import (
    AsyncConfig,
    AsyncFederation,
    AvailabilityConfig,
    Federation,
    FLRunConfig,
    TraceAvailabilityConfig,
    make_availability,
    masked_accuracy,
)
from repro_torch.models import cnn
from repro_torch.obs import ObsConfig
from repro_torch.utils.checkpoint import latest_step
from repro_torch.utils.device import resolve_device

METHOD_NAMES = sorted(bl.METHODS) + ["pfedsop_nopc"]


def build_method(name, lr, args):
    if name == "pfedsop":
        return bl.PFedSOP(cfg=PFedSOPConfig(eta1=lr, eta2=lr, rho=args.rho, lam=args.lam))
    if name == "pfedsop_nopc":
        return bl.PFedSOP(cfg=PFedSOPConfig(eta1=lr, eta2=lr, rho=args.rho,
                                            lam=args.lam, use_pc=False),
                          name="pfedsop_nopc")
    if name == "fedrep":
        return bl.FedRep(lr=lr, head_predicate=lambda p: "fc_" in p)
    if name == "fedprox":
        return bl.FedProx(lr=lr, mu=args.mu)
    if name == "fedprox_ft":
        return bl.FedProxFT(lr=lr, mu=args.mu)
    if name == "ditto":
        return bl.Ditto(lr=lr, lam=args.ditto_lam)
    return bl.METHODS[name](lr=lr)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--methods", nargs="+", default=["pfedsop", "fedavg"],
                    choices=METHOD_NAMES)
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
    ap.add_argument("--local-iters", type=int, default=0,
                    help="local SGD steps per round (0 = one local epoch)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--mu", type=float, default=0.1)
    ap.add_argument("--ditto-lam", type=float, default=0.1)
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
    # -- not ported yet: refused with the ROADMAP item --------------------
    ap.add_argument("--store", choices=["device", "host", "mmap"], default="device",
                    help="client state at rest; only 'device' is ported "
                         "(host/mmap: ROADMAP.md queue 1, item 12)")
    ap.add_argument("--backend", choices=["vmap", "shard_map", "mesh"], default="vmap",
                    help="only 'vmap' is ported (multi-device: ROADMAP.md "
                         "queue 1, item 16)")
    ap.add_argument("--mesh", default="", help="not ported (ROADMAP.md item 16)")
    ap.add_argument("--shards", type=int, default=0,
                    help="not ported (ROADMAP.md item 16)")
    # -- async federation -------------------------------------------------
    ap.add_argument("--mode", choices=["sync", "async"], default="sync",
                    help="sync: bulk-synchronous rounds (the paper's setup); "
                         "async: availability-aware discrete-event simulation "
                         "with FedBuff-style buffered staleness-weighted "
                         "aggregation; 'rounds' then counts applied server "
                         "updates")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="async: uploads per server update (0 = K')")
    ap.add_argument("--concurrency", type=int, default=0,
                    help="async: clients kept in flight (0 = K')")
    ap.add_argument("--speed", choices=["fixed", "lognormal"], default="fixed",
                    help="per-client compute-speed model (async scheduling "
                         "and the sync simulated round clock)")
    ap.add_argument("--speed-sigma", type=float, default=1.0,
                    help="lognormal sigma of the per-client speed multipliers")
    ap.add_argument("--mean-duration", type=float, default=1.0,
                    help="median simulated client round duration")
    ap.add_argument("--availability", default="1.0",
                    help="a steady-state online fraction per client (1.0 = "
                         "always on) or 'trace:<path>' to replay a recorded "
                         "device trace file (see examples/traces/)")
    ap.add_argument("--mean-on", type=float, default=10.0,
                    help="mean online-stretch length (sim seconds)")
    # -- observability ----------------------------------------------------
    ap.add_argument("--trace-dir", default="",
                    help="write a structured event trace under this directory "
                         "(per-method subdirs); scripts/trace_report.py "
                         "summarizes it")
    ap.add_argument("--metrics", default="",
                    help="metrics.jsonl path ('' = <trace-dir>/<method>/"
                         "metrics.jsonl when tracing)")
    ap.add_argument("--obs-level", choices=["off", "round", "phase", "kernel"],
                    default="phase",
                    help="round = round spans + metrics; phase = + per-phase "
                         "spans synchronized with the card; kernel = + NVTX "
                         "ranges and events around kernel call sites")
    ap.add_argument("--profile-round", type=int, default=-1,
                    help="capture a torch.profiler trace of this round/version "
                         "under <trace-dir>/<method>/torch_profile (-1 = off)")
    ap.add_argument("--obs-quiet", action="store_true",
                    help="suppress the drivers' stdout progress lines")
    # -- checkpointing ----------------------------------------------------
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the whole driver state every N applied "
                         "server updates (0 = off)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (per-method subdirs)")
    ap.add_argument("--resume", action="store_true",
                    help="resume each method from its latest checkpoint under "
                         "--ckpt-dir (a bitwise continuation)")
    ap.add_argument("--tag", default="run")
    args = ap.parse_args(argv)

    if args.store != "device":
        raise NotImplementedError(
            f"--store {args.store} is not ported to repro_torch yet (host/mmap "
            "stores and the LRU cache: ROADMAP.md queue 1, item 12)")
    if args.backend != "vmap" or args.mesh or args.shards:
        raise NotImplementedError(
            "--backend shard_map/mesh, --mesh and --shards are not ported to "
            "repro_torch yet (multi-device: ROADMAP.md queue 1, item 16)")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every requires --ckpt-dir")
    if args.mode != "async" and (args.buffer_size or args.concurrency):
        ap.error("--buffer-size/--concurrency only apply to --mode async")
    if args.profile_round >= 0 and not args.trace_dir:
        ap.error("--profile-round writes under <trace-dir>/<method>/torch_profile, "
                 "so it requires --trace-dir")
    if args.obs_level == "off" and (args.trace_dir or args.metrics):
        ap.error("--obs-level off disables every sink, so --trace-dir/"
                 "--metrics would be silently ignored")
    if args.metrics and len(args.methods) > 1:
        ap.error("--metrics names a single file that each of the "
                 f"{len(args.methods)} --methods would clobber; use --trace-dir")
    if args.availability.startswith("trace:"):
        if (args.speed != "fixed" or args.speed_sigma != 1.0
                or args.mean_duration != 1.0 or args.mean_on != 10.0):
            ap.error("--availability trace:<path> replays durations and "
                     "on/off windows from the file; --speed/--speed-sigma/"
                     "--mean-duration/--mean-on would be silently ignored")
    else:
        try:
            float(args.availability)
        except ValueError:
            ap.error(f"--availability must be a float or 'trace:<path>', "
                     f"got {args.availability!r}")
    if args.update_impl and not any(m.startswith("pfedsop") for m in args.methods):
        ap.error("--update-impl targets the pFedSOP round-start update; none "
                 f"of --methods {args.methods} has it")
    if args.paper_scale:
        args.clients, args.participation, args.rounds = 100, 0.2, 100
        args.samples = 20000
    return args


def availability_config(args):
    if args.availability.startswith("trace:"):
        return TraceAvailabilityConfig(path=args.availability[len("trace:"):])
    return AvailabilityConfig(speed=args.speed, mean_duration=args.mean_duration,
                              sigma=args.speed_sigma,
                              availability=float(args.availability),
                              mean_on=args.mean_on)


def main(argv=None):
    args = parse_args(argv)
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
    avail_cfg = availability_config(args)
    run_cfg = FLRunConfig(
        n_clients=args.clients, participation=args.participation,
        rounds=args.rounds, batch=args.batch, local_iters=args.local_iters,
        seed=args.seed, ckpt_every=args.ckpt_every,
        async_cfg=AsyncConfig(buffer_size=args.buffer_size,
                              concurrency=args.concurrency,
                              availability=avail_cfg))

    results = {}
    for name in args.methods:
        # --update-impl targets the pFedSOP round-start update; the
        # baselines have no such knob
        cfg_m = replace(run_cfg, update_impl=args.update_impl
                        if name.startswith("pfedsop") else "")
        if args.ckpt_dir:
            cfg_m = replace(cfg_m, ckpt_dir=str(Path(args.ckpt_dir) / name))
        if args.trace_dir or args.metrics or args.obs_quiet:
            cfg_m = replace(cfg_m, obs=ObsConfig(
                trace_dir=str(Path(args.trace_dir) / name) if args.trace_dir else "",
                metrics=args.metrics, level=args.obs_level, quiet=args.obs_quiet,
                profile_round=args.profile_round))
        method = build_method(name, args.lr, args)
        if args.mode == "async":
            fed = AsyncFederation(method, loss, acc, params, data, cfg_m,
                                  device=args.device)
        else:
            # the sync driver samples obliviously and waits for stragglers,
            # timed by the same heterogeneity model, so sim_time compares
            model = make_availability(avail_cfg, args.clients, args.seed)
            fed = Federation(method, loss, acc, params, data, cfg_m,
                             availability=model, device=args.device)
        if args.resume and latest_step(cfg_m.ckpt_dir) is not None:
            at = fed.restore()
            fed.obs.log.info(f"[{name}] resumed from {cfg_m.ckpt_dir} at round {at}",
                             event="resume_notice", method=name, round=int(at))
        hist = fed.run(verbose=True)
        results[name] = hist
        rt = hist["round_time"][1:] or hist["round_time"]
        fed.obs.log.info(
            f"--> {name}: mean best acc {hist['mean_best_acc']:.4f}, "
            f"mean round time {np.mean(rt):.3f}s, "
            f"sim wall-clock {hist['sim_time'][-1]:.1f}",
            event="method_summary", method=name,
            mean_best_acc=float(hist["mean_best_acc"]))

    out_dir = Path("experiments/fl")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{args.tag}_{args.partition}_{args.clients}c_{args.rounds}r"
    payload = {"args": vars(args), "results": results}
    (out_dir / f"{tag}.json").write_text(json.dumps(payload, indent=1))
    print(f"\nwrote experiments/fl/{tag}.json")
    print(f"{'method':>14} {'best_acc':>9} {'final_loss':>11}")
    for name, h in results.items():
        print(f"{name:>14} {h['mean_best_acc']:>9.4f} {h['loss'][-1]:>11.4f}")
    return results


if __name__ == "__main__":
    main()
