"""``repro``'s GSPMD-partitioned serving steps, the reference of
``tests/test_torch_tp_serve.py``.

Runs ``repro``'s ``make_prefill_step`` / ``make_serve_step`` (and
``prefill_with_caches`` / ``decode_step``, for the caches and each step's
logits) under ``jax.jit`` with ``NamedSharding``s from
``sharding.param_pspecs`` / ``batch_pspecs`` / ``cache_pspecs`` on a
forced 4-device CPU mesh, data 2 x model 2, as ``repro/launch/dryrun.py``
shards its serve shapes.  The device count must be set before JAX starts,
so the test runs this file in a subprocess:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/tp_serve_reference.py OUT.pkl

and pickles, per case of ``torch_dist_workers.TP_CASES``: the params
(numpy, ``repro``'s tree), the prompt, the prefill step's logits,
``prefill_with_caches``'s logits, and for each decode step (greedy, on its
own tokens) its input, its logits and the serve step's tokens.  Imports
nothing of the port (``torch_dist_workers`` imports numpy only at the
top).
"""
from __future__ import annotations

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import sharding as sh
from repro.launch import steps as st
from repro.launch.mesh import MeshSpec
from repro.models import transformer as tf
from torch_dist_workers import TP_B as B
from torch_dist_workers import TP_CAPACITY as CAPACITY
from torch_dist_workers import TP_CASES, tp_config
from torch_dist_workers import TP_S as S
from torch_dist_workers import TP_T as T


def prompt(cfg, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _named(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def run_case(mesh, cfg, seed: int) -> dict:
    params = tf.init_params(jax.random.PRNGKey(seed), cfg)
    tokens = prompt(cfg, seed)
    pp = sh.param_pspecs(params, 2)
    stacked = jax.tree.map(lambda x: x[None], params)
    spp = sh.param_pspecs(stacked, 2, client=True, client_axis=None)
    shape = InputShape("tp_serve", CAPACITY, B, "prefill")

    prefill_step = jax.jit(
        st.make_prefill_step(cfg, shape),
        in_shardings=_named(mesh, (spp, sh.batch_pspecs({"tokens": tokens[None]}, 2, client=True,
                                                        client_axis=None))),
        out_shardings=NamedSharding(mesh, P()))
    step_logits = prefill_step(stacked, {"tokens": tokens[None]})[0]

    cache_struct = jax.eval_shape(lambda: tf.init_caches(cfg, B, CAPACITY))
    cp = sh.cache_pspecs(cache_struct, 2, 2)
    scp = sh.cache_pspecs(jax.tree.map(lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype),
                                       cache_struct), 2, 2, client=True, client_axis=None)
    tok_sh = sh.batch_pspecs({"tokens": np.zeros((B, 1), np.int32)}, 2)
    stok_sh = sh.batch_pspecs({"tokens": np.zeros((1, B, 1), np.int32)}, 2, client=True,
                              client_axis=None)
    prefill = jax.jit(lambda p, b: tf.prefill_with_caches(p, cfg, b, capacity=CAPACITY),
                      in_shardings=_named(mesh, (pp, sh.batch_pspecs({"tokens": tokens}, 2))),
                      out_shardings=_named(mesh, (P(), cp)))
    decode = jax.jit(lambda p, b, pos, c: tf.decode_step(p, cfg, b, pos, c),
                     in_shardings=_named(mesh, (pp, tok_sh, P(), cp)),
                     out_shardings=_named(mesh, (P(), cp)))
    serve = jax.jit(st.make_serve_step(cfg, shape),
                    in_shardings=_named(mesh, (spp, stok_sh, P(), scp)),
                    out_shardings=_named(mesh, (P(), scp)))

    def put(tree, specs):  # the inputs placed as each step's in_shardings say
        return jax.device_put(tree, _named(mesh, specs))

    logits, caches = prefill(params, {"tokens": tokens})
    tok = np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))
    out = {"params": jax.tree.map(np.asarray, params), "prompt": tokens,
           "prefill_step": np.asarray(step_logits), "prefill": np.asarray(logits),
           "inputs": [], "decode": [], "serve": []}
    for t in range(T):
        pos = jnp.int32(S + t)
        served = serve(stacked, {"tokens": tok[None]}, pos,
                       put(jax.tree.map(lambda x: x[None], caches), scp))
        logits, caches = decode(params, {"tokens": tok}, pos, caches)
        out["inputs"].append(tok)
        out["decode"].append(np.asarray(logits))
        out["serve"].append(np.asarray(served[0][0]))
        tok = np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))
    return out


def main(path: str) -> None:
    if len(jax.devices()) != 4:
        raise SystemExit(f"needs 4 devices (XLA_FLAGS=--xla_force_host_platform_device_count"
                         f"=4), found {len(jax.devices())}")
    spec = MeshSpec.single_pod(2, 2)
    # repro's axes over the 4 devices, in Auto mode as its dry run lowers
    # (jax.make_mesh's default Explicit axes refuse the decode step's
    # dynamic_update_slice of a replicated update into the sharded cache)
    mesh = Mesh(np.asarray(jax.devices()).reshape(spec.shape), spec.axes)
    results = {name: run_case(mesh, tp_config(get_config, arch, variant), seed=i)
               for i, (name, (arch, variant)) in enumerate(TP_CASES.items())}
    with open(path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1])
