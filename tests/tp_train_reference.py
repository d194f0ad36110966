"""``repro``'s jit-partitioned train step, the reference of
``tests/test_torch_tp_train.py``.

Builds ``repro``'s ``make_train_step`` and jits it as
``repro/launch/train.py`` does for its replicated step: the client state
and the global delta sharded over ``model`` by ``sharding.param_pspecs``
(``in_shardings``), the batches left to the partitioner, on a forced
4-device CPU mesh, data 2 x model 2.  The device count must be set before
JAX starts, so the test runs this file in a subprocess:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/tp_train_reference.py IN.pkl OUT.pkl

and pickles, per case of ``torch_dist_workers.TT_CASES``, first the step's
inputs as numpy to IN.pkl (the client-stacked state, params from
``repro``'s init plus seeded noise and a noise local delta; a noise global
delta; tokens and their next tokens as labels), then its outputs to
OUT.pkl (state', global delta', loss; for the MoE cases also the outputs
at ``grad_chunks`` 2, the reference of a data axis of 2), so the port's
ranks can start while the steps compile.  Imports nothing of the port.
"""
from __future__ import annotations

import os
import pickle
import sys

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core.pfedsop import PFedSOPConfig
from repro.kernels.dispatch import grad_chunk_count
from repro.launch import sharding as sh
from repro.launch import steps as st
from repro.launch.mesh import MeshSpec
from repro.models import transformer as tf
from torch_dist_workers import TT_B, TT_CASES, TT_NOISE, TT_PCFG, TT_S, TT_T, tp_config


def _named(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def inputs(cfg, seed: int) -> dict:
    """One case's step inputs (numpy): the client-stacked state (``repro``'s
    init plus noise, a noise local delta), a noise global delta, tokens and
    their next tokens as labels."""
    params = jax.tree.map(np.asarray, tf.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)

    def noise(x):
        return (TT_NOISE * rng.standard_normal(x.shape)).astype(np.float32)

    state = {"params": jax.tree.map(lambda x: (x + noise(x))[None], params),
             "delta": jax.tree.map(lambda x: noise(x)[None], params)}
    gd = jax.tree.map(noise, params)
    toks = rng.randint(0, cfg.vocab_size, (1, TT_T, TT_B, TT_S)).astype(np.int32)
    return {"state": state, "gd": gd, "batches": {"tokens": toks,
                                                  "labels": np.roll(toks, -1, -1)}}


def run_case(mesh, cfg, case: dict) -> dict:
    """The jit-partitioned step's outputs (state', global delta', loss) on
    ``case``'s inputs: "out", and for the MoE "out2" at ``grad_chunks`` 2."""
    state, gd = case["state"], case["gd"]
    shape = InputShape("tp_train", TT_S, TT_B * TT_T, "train")
    msize = mesh.shape["model"]
    pspec = sh.param_pspecs(state["params"], msize, client=True)
    in_sh = ({"params": pspec, "delta": pspec}, sh.param_pspecs(gd, msize), None)
    out = {}
    # a data axis of 2 splits each micro batch into 2 gradient chunks; the
    # chunks' mean is the batch's gradient within f32 order, except where
    # the loss does not average over rows: the MoE (aux loss, capacity)
    for key, chunks in (("out", 1), ("out2", 2))[:1 + (cfg.n_experts > 0)]:
        step = st.make_train_step(cfg, shape, PFedSOPConfig(**TT_PCFG))
        jit_step = jax.jit(step, in_shardings=(_named(mesh, in_sh[0]),
                                               _named(mesh, in_sh[1]), None))
        with mesh, grad_chunk_count(chunks):
            new_state, new_gd, loss = jit_step(state, gd, case["batches"])
        out[key] = (jax.tree.map(np.asarray, new_state), jax.tree.map(np.asarray, new_gd),
                    float(loss))
    return out


def _dump(obj, path: str) -> None:
    with open(path + ".part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".part", path)  # whole or absent: a reader polls for it


def main(inputs_path: str, outputs_path: str) -> None:
    if len(jax.devices()) != 4:
        raise SystemExit(f"needs 4 devices (XLA_FLAGS=--xla_force_host_platform_device_count"
                         f"=4), found {len(jax.devices())}")
    spec = MeshSpec.single_pod(2, 2)
    mesh = Mesh(np.asarray(jax.devices()).reshape(spec.shape), spec.axes)
    cfgs = {name: tp_config(get_config, arch, variant)
            for name, (arch, variant) in TT_CASES.items()}
    cases = {name: inputs(cfg, seed=i) for i, (name, cfg) in enumerate(cfgs.items())}
    _dump(cases, inputs_path)  # the port's ranks start from these
    _dump({name: run_case(mesh, cfgs[name], case) for name, case in cases.items()},
          outputs_path)


if __name__ == "__main__":
    main(*sys.argv[1:])
