"""Serving driver: batched greedy decode sessions through ``make_serve_step``.

Port of ``repro/launch/serve.py`` with its flags (``--arch --batch --steps
--capacity --seed --kernel-impl``), plus the port's ``--device`` (default
``cuda``) and ``--full`` (the arch's full config instead of the reduced
CPU-smoke variant), and ``--prompt-len N``, which takes
``examples/serve_decode.py``'s path: N random prompt tokens fed one by one
through the decode step, then greedy decode.  Without it the sessions
start from token 0 at position 0, as ``repro``'s driver does.  Every arch
serves: the codebook archs feed one token per codebook a step, the vision
arch tokens beside zero patch embeddings (``steps.decode_batch``).  Prints
the prompt time, the first decode call and the decode rate after it.

``--mesh`` (a port flag, ``launch/mesh.py``'s grammar, e.g. ``pods:1x1x2``)
serves tensor-parallel, one rank of the mesh a process: it joins
``torchrun``'s group (``collectives.init_world``), cuts the params and
caches to this rank's slices (``launch/sharding.py::rank_plan``) and the
batch to its data rank's rows, and runs ``make_serve_step(tp=)``; the
tokens are whole on every rank, and rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --prompt-len 8 --steps 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch musicgen-large
  PYTHONPATH=src python -m repro_torch.launch.serve --full --arch gemma3-1b --batch 4 --steps 32
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \
      --arch granite-moe-1b-a400m --mesh pods:1x1x2 --prompt-len 8 --steps 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels.dispatch import check_impl_name
from repro_torch.launch import collectives
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import parse_mesh
from repro_torch.launch.sharding import rank_plan
from repro_torch.models import transformer as tf
from repro_torch.utils.device import resolve_device
from repro_torch.weights import cut


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=64,
                    help="KV-cache capacity of the full-attention layers, in tokens")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-impl", default="auto",
                    choices=["auto", "reference", "kernel", "kernel_interpret"],
                    help="model kernel policy (rmsnorm/flash_gqa): the CUDA kernels "
                         "('kernel'; 'auto' on the card) or the plain reference")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="feed this many random prompt tokens through the decode "
                         "step before the greedy decode (0 = start from token 0)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config instead of the reduced smoke variant")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--mesh", default=None,
                    help="serve tensor-parallel as one rank of this mesh (e.g. pods:1x1x2; "
                         "one process a rank, under torchrun)")
    args = ap.parse_args(argv)
    try:
        check_impl_name(args.kernel_impl, "rmsnorm/flash_gqa")
    except ValueError as e:
        ap.error(str(e))
    if args.prompt_len and args.prompt_len + args.steps > args.capacity:
        ap.error(f"--prompt-len {args.prompt_len} + --steps {args.steps} exceeds "
                 f"--capacity {args.capacity}: the full-attention caches would wrap "
                 "onto the prompt")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full).replace(kernel_impl=args.kernel_impl)
    shape = InputShape("custom_decode", args.capacity, args.batch, "decode")
    tp, say = None, print
    if args.mesh:
        collectives.init_world(dev)
        tp = st.tensor_parallel(parse_mesh(args.mesh))
        if torch.distributed.get_rank():
            say = lambda *a, **k: None  # noqa: E731 - rank 0 prints
    serve_step = st.make_serve_step(cfg, shape, tp)
    b = args.batch
    say(f"serving {cfg.name}: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
        f"{cfg.dtype}, batch {b}, capacity {args.capacity}, kernel_impl="
        f"{cfg.kernel_impl}, device={dev}" + (f", mesh {args.mesh}" if tp else ""), flush=True)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    caches = tf.init_caches(cfg, b, args.capacity, device=dev)
    rows = lambda x: x  # noqa: E731 - this data rank's rows of a batch leaf
    if tp is not None:
        params = cut(params, rank_plan(params, "params", tp.data_size, tp.size, tp.data_rank,
                                       tp.rank))
        caches = cut(caches, rank_plan(caches, "caches", tp.data_size, tp.size, tp.data_rank,
                                       tp.rank))
        if b % tp.data_size == 0:
            n = b // tp.data_size
            rows = lambda x: x[tp.data_rank * n:(tp.data_rank + 1) * n]  # noqa: E731

    pos = 0
    batch = {k: rows(torch.zeros(shape, dtype=dt, device=dev))
             for k, (shape, dt) in st.decode_batch(cfg, b).items()}
    t0 = time.perf_counter()
    if args.prompt_len:
        g = torch.Generator(device=dev).manual_seed(args.seed + 1)
        prompts = torch.randint(0, cfg.vocab_size, (b,) + batch["tokens"].shape[1:-1]
                                + (args.prompt_len,), generator=g, device=dev)
        for pos in range(args.prompt_len):
            batch["tokens"] = rows(prompts[..., pos:pos + 1])
            tok, caches = serve_step(params, batch, pos, caches)
            batch["tokens"] = rows(st.next_tokens(cfg, tok))
        pos += 1
        _sync(dev)
        say(f"prompt: {args.prompt_len} tokens x {b} sequences fed token by token in "
            f"{time.perf_counter() - t0:.3f}s", flush=True)

    out = []
    t1 = time.perf_counter()
    for t in range(args.steps):
        tok, caches = serve_step(params, batch, pos + t, caches)
        batch["tokens"] = rows(st.next_tokens(cfg, tok))
        out.append(tok)
        if t == 0:
            _sync(dev)
            t2 = time.perf_counter()
    _sync(dev)
    t3 = time.perf_counter()
    gen = torch.cat(out, dim=1).cpu().numpy()
    say(f"first decode call: {t2 - t1:.3f}s", flush=True)
    if args.steps > 1:
        dt = t3 - t2
        say(f"decode: {args.steps - 1} steps x {b} sequences in {dt:.3f}s, "
            f"{1e3 * dt / (args.steps - 1):.3f} ms/step, "
            f"{(args.steps - 1) * b / dt:.1f} tokens/s", flush=True)
    say("sample token ids:", gen[:, :10].tolist())
    assert np.all(gen >= 0) and np.all(gen < cfg.vocab_size)
    say("OK")
    return gen


if __name__ == "__main__":
    main()
