"""Production training driver (port of ``repro/launch/train.py``).

Assembles the mesh, the pFedSOP round step (``launch/steps.py::
make_train_step``) and real rounds of one client's training on the ranks
that exist: a one-rank group on the ``host`` mesh (a smoke run of the
production code path), or ``torchrun``'s world laid out as the 16x16
(data, model) mesh under ``--production-mesh``, which needs 256 ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch granite-3-2b \\
      --rounds 3 --seq-len 64 --micro-batch 2 --local-iters 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --output-sharding sharded

The flags are ``repro``'s, with the same obs fingerprint, logging events,
per-round metrics (``train.loss``, ``train.round_time``) and checkpoints
(``utils/checkpoint.py::save_checkpoint`` of the client state after each
round), plus the port's ``--device`` (default ``cuda``).  ``--xla-profile``
is the port's ``--profile-round`` (a ``torch.profiler`` capture of one round
under ``<trace-dir>/torch_profile``); ``--kernel-impl kernel_interpret`` is
refused (a CUDA kernel has no interpreter).

``--output-sharding``: "replicated" runs the engine-less step on every rank;
"sharded" runs it through ``MeshBackend(1, spec, strict=False,
data_chunks=<data size>)``, the federation's mesh engine, whose data split
engages when the micro batch divides over the data axis (else the step
takes its one gradient in the body).  The two give the same numbers.

``--reduced`` is ``repro``'s ``store_true`` with ``default=True``: the
flag cannot be turned off, so the CLI always runs the reduced config
(ROADMAP.md, ``repro``'s fault R5).  ``run`` takes the ``ModelConfig``
itself, which is how ``chip_smoke.py`` drives the full-width config
through the same round loop.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import lm_batch_iterator, synthetic_lm_stream
from repro_torch.fl.engine import MeshBackend
from repro_torch.kernels.dispatch import check_impl_name
from repro_torch.launch import collectives
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import MeshSpec, make_host_mesh, resolve_mesh
from repro_torch.models import transformer as tf
from repro_torch.obs import NOOP, Obs, ObsConfig, make_obs
from repro_torch.utils.checkpoint import save_checkpoint
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def run(cfg, *, rounds: int = 3, local_iters: int = 2, micro_batch: int = 2,
        seq_len: int = 64, seed: int = 0, output_sharding: str = "replicated",
        production_mesh: bool = False, checkpoint_dir=None, obs: Obs = NOOP,
        device="cuda"):
    """``repro``'s round loop on ``cfg`` inside the initialized process
    group: ``rounds`` train steps of one client (``local_iters`` micro
    batches of ``micro_batch`` x ``seq_len`` tokens a step) from
    ``tf.init_params`` seeded by ``seed`` (an explicit ``torch.Generator``),
    zero local and global deltas.  Returns ({"loss", "round_time"} per
    round, (the final client state, the global delta))."""
    device = resolve_device(device)
    if production_mesh:
        spec = MeshSpec.single_pod(16, 16)
        resolve_mesh(spec)  # refuses a world other than 256, with the grammar
    else:
        spec = MeshSpec.host()
        make_host_mesh()
    layout = dict(zip(spec.axes, spec.shape))
    obs.open(fingerprint={
        "driver": "launch", "arch": cfg.name, "mesh": layout, "seed": seed,
        "kernel_impl": cfg.kernel_impl, "seq_len": seq_len, "micro_batch": micro_batch,
        "local_iters": local_iters,
    })
    obs.log.info(f"mesh {layout}, arch {cfg.name}", event="run_start", mesh=layout,
                 arch=cfg.name)

    shape = InputShape("custom", seq_len, micro_batch * local_iters, "train")
    engine = None
    if output_sharding == "sharded":
        engine = MeshBackend(1, spec, strict=False, data_chunks=spec.data_size)
    elif output_sharding != "replicated":
        raise ValueError(f"output_sharding must be 'replicated' or 'sharded', got "
                         f"{output_sharding!r}")
    step = st.make_train_step(cfg, shape, engine=engine)

    params = tf.init_params(torch.Generator(device=device).manual_seed(seed), cfg,
                            device=device)
    zeros = tree_map(torch.zeros_like, params)
    state = tree_map(lambda x: x.unsqueeze(0), {"params": params, "delta": zeros})
    global_delta = zeros
    del params, zeros

    stream = synthetic_lm_stream(50_000, cfg.vocab_size, seed=seed)
    it = lm_batch_iterator(stream, micro_batch, seq_len, seed=seed)
    hist = {"loss": [], "round_time": []}
    for r in range(rounds):
        t0 = time.perf_counter()
        obs.profile_round_start(r)
        with obs.span("round", round=r):
            bs = [next(it) for _ in range(local_iters)]
            batches = {k: torch.from_numpy(np.stack([b[k] for b in bs])[None]).to(device)
                       for k in bs[0]}  # (1, T, b, S)
            state, global_delta, loss = obs.timed("train_step", step, state, global_delta,
                                                  batches, round=r)
        loss = float(loss)  # waits for the step
        obs.profile_round_end(r)
        dt = time.perf_counter() - t0
        hist["loss"].append(loss)
        hist["round_time"].append(dt)
        obs.log.info(f"round {r} loss={loss:.4f} ({dt:.1f}s)", event="round", round=r,
                     loss=loss, round_time=dt)
        if obs.metrics is not None:
            obs.metrics.gauge("train.loss").set(loss)
            obs.metrics.gauge("train.round_time").set(dt)
            obs.flush_metrics(step=r)
        obs.flush()
        if checkpoint_dir and collectives.world_rank() == 0:
            save_checkpoint(checkpoint_dir, r, state)
    obs.close()
    return hist, (state, global_delta)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="granite-3-2b")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-iters", type=int, default=2)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the reduced config (always on, as in repro)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (requires 256 ranks)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output-sharding", choices=["replicated", "sharded"],
                    default="replicated",
                    help="'sharded' routes the client phase and Eq. 13 through the "
                         "federation's MeshBackend; 'replicated' runs the engine-less "
                         "step. The same numbers")
    ap.add_argument("--kernel-impl", default="auto",
                    choices=["auto", "reference", "kernel", "kernel_interpret"],
                    help="model kernel policy (rmsnorm/flash_gqa): auto = the CUDA "
                         "kernels on the card, their plain versions on the CPU")
    ap.add_argument("--trace-dir", default="",
                    help="structured round trace + Perfetto trace.json export")
    ap.add_argument("--metrics", default="",
                    help="metrics.jsonl path ('' = <trace-dir>/metrics.jsonl)")
    ap.add_argument("--obs-level", choices=["off", "round", "phase", "kernel"],
                    default="phase")
    ap.add_argument("--xla-profile", "--profile-round", dest="profile_round", type=int,
                    default=-1, help="round index to wrap in a torch.profiler capture "
                                     "under <trace-dir>/torch_profile (-1 = off)")
    ap.add_argument("--obs-quiet", action="store_true",
                    help="suppress stdout progress lines (records still trace)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)
    if args.profile_round >= 0 and not args.trace_dir:
        ap.error("--xla-profile requires --trace-dir")
    try:
        check_impl_name(args.kernel_impl, "--kernel-impl")
    except ValueError as e:
        ap.error(str(e))
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, reduced=args.reduced).replace(kernel_impl=args.kernel_impl)
    if cfg.frontend != "none":
        raise SystemExit("text archs only in this driver")
    # join torchrun's group, or start a one-rank group
    own_group = not torch.distributed.is_initialized()
    if own_group:
        collectives.init_world(device)
    try:
        rank = collectives.world_rank()
        if rank == 0:
            obs = make_obs(ObsConfig(
                trace_dir=args.trace_dir, metrics=args.metrics, level=args.obs_level,
                quiet=args.obs_quiet, profile_round=args.profile_round,
            ) if (args.trace_dir or args.metrics or args.obs_quiet) else None)
        else:  # rank 0 speaks and traces for the group
            obs = Obs(ObsConfig(quiet=True))
        hist, _ = run(cfg, rounds=args.rounds, local_iters=args.local_iters,
                      micro_batch=args.micro_batch, seq_len=args.seq_len, seed=args.seed,
                      output_sharding=args.output_sharding,
                      production_mesh=args.production_mesh,
                      checkpoint_dir=args.checkpoint_dir, obs=obs, device=device)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()
    assert np.isfinite(hist["loss"][-1])
    if rank == 0:
        print("OK")


if __name__ == "__main__":
    main()
