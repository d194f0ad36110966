"""``repro``'s ``seqshard`` prefill, the reference of
``tests/test_torch_seqshard.py``.

Runs ``repro``'s ``make_prefill_step`` with ``cfg.seq_shard`` under plain
``jax.jit`` inside ``with mesh:``, as ``repro/launch/dryrun.py`` lowers its
``seqshard`` variant: params placed on ``_strip_model_axis`` of
``sharding.param_pspecs`` (every layer weight replicated, ``embed`` on the
vocab), the batch on ``batch_pspecs``; ``forward``'s pin puts the residual
stream on ``P("data", "model", None)``.  A forced 4-device CPU mesh, data 2
x model 2.  The device count must be set before JAX starts, so the test
runs this file in a subprocess:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/seqshard_reference.py IN.pkl OUT.pkl

It pickles, per case of ``torch_dist_workers.SQ_CASES``, first the inputs
as numpy to IN.pkl (``repro``'s init, a prompt from the case's seed), then
to OUT.pkl the step's last-position logits (B, 1, V), (B, 1, K, V) for
the codebooks; and, for every arch
at full width and m = 2, 4 and 16, the specs ``_strip_model_axis`` gives
its params (``{keystr: spec}``), so the port's ranks can start while the
steps compile.  Imports nothing of the port.
"""
from __future__ import annotations

import os
import pickle
import sys

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES, get_config
from repro.configs.base import InputShape
from repro.launch import sharding as sh
from repro.launch import steps as st
from repro.launch.mesh import MeshSpec
from repro.models import transformer as tf
from torch_dist_workers import SQ_B, SQ_CASES, sq_config, sq_len, sq_prompt


def _named(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def _stacked(tree):
    return jax.tree.map(lambda x: x[None], tree)


def run_case(mesh, strip, cfg, case: dict, s: int) -> np.ndarray:
    """The seqshard prefill step's last-position logits on ``case``, a
    prompt of ``s`` positions."""
    shape = InputShape("seqshard", s, SQ_B, "prefill")
    params, batch = _stacked(case["params"]), _stacked(case["prompt"])
    in_sh = (strip(sh.param_pspecs(params, mesh.shape["model"], client=True,
                                   client_axis=None)),
             sh.batch_pspecs(batch, mesh.shape["data"], client=True, client_axis=None))
    step = jax.jit(st.make_prefill_step(cfg, shape), in_shardings=_named(mesh, in_sh),
                   out_shardings=NamedSharding(mesh, P()))
    with mesh:
        return np.asarray(step(params, batch)[0])


def stripped_specs(strip) -> dict:
    """arch -> m -> {keystr(path): spec} of ``strip`` on the full config's
    param specs."""
    out = {}
    for arch in ARCH_NAMES:
        tree = jax.eval_shape(lambda a=arch: tf.init_params(jax.random.PRNGKey(0),
                                                            get_config(a)))
        out[arch] = {}
        for m in (2, 4, 16):
            specs = strip(sh.param_pspecs(tree, m))
            out[arch][m] = {jax.tree_util.keystr(p): tuple(s) for p, s in
                            jax.tree_util.tree_flatten_with_path(
                                specs, is_leaf=lambda x: isinstance(x, P))[0]}
    return out


def _dump(obj, path: str) -> None:
    with open(path + ".part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".part", path)  # whole or absent: a reader polls for it


def main(inputs_path: str, outputs_path: str) -> None:
    if len(jax.devices()) != 4:
        raise SystemExit(f"needs 4 devices (XLA_FLAGS=--xla_force_host_platform_device_count"
                         f"=4), found {len(jax.devices())}")
    # JAX has started with its 4 devices: the dry run's own device count
    # (set when its module is imported) no longer applies
    from repro.launch.dryrun import _strip_model_axis

    spec = MeshSpec.single_pod(2, 2)
    mesh = Mesh(np.asarray(jax.devices()).reshape(spec.shape), spec.axes)
    cfgs = {name: sq_config(get_config, name) for name in SQ_CASES}
    cases = {name: {"params": jax.tree.map(np.asarray, tf.init_params(
        jax.random.PRNGKey(i), cfg)), "prompt": sq_prompt(cfg, i, sq_len(name))}
        for i, (name, cfg) in enumerate(cfgs.items())}
    _dump(cases, inputs_path)  # the port's ranks start from these
    _dump({"logits": {name: run_case(mesh, _strip_model_axis, cfgs[name], case, sq_len(name))
                      for name, case in cases.items()},
           "stripped": stripped_specs(_strip_model_axis)}, outputs_path)


if __name__ == "__main__":
    main(*sys.argv[1:])
