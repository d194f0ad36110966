"""The port's substrate against ``repro``: copied modules, the flat leaf
order, the ordered cohort reductions, the no-JAX rule and the device rule.

Everything here is bitwise: numpy/stdlib copies, elementwise f32 adds in
one fixed association, and pure data movement.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resnet_cifar as j_configs
from repro.data import (
    FederatedData as JData,
    dirichlet_partition as j_dirichlet,
    make_class_conditional_images as j_images,
    pathological_partition as j_pathological,
)
from repro.models import cnn as j_cnn
from repro.optim.reduce import cohort_mean as j_cohort_mean
from repro.optim.reduce import ordered_axis_sum as j_ordered_axis_sum
from repro.utils.pytree import tree_flatten_to_vector
from repro_torch.configs import resnet_cifar as t_configs
from repro_torch.data import (
    FederatedData as TData,
    dirichlet_partition as t_dirichlet,
    make_class_conditional_images as t_images,
    pathological_partition as t_pathological,
)
from repro_torch.optim.reduce import cohort_mean, ordered_axis_sum
from repro_torch.utils.pytree import FlatLayout, tree_leaves
from repro_torch.weights import params_from_jax, params_to_numpy

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("rel", ["data/synthetic.py", "data/partition.py",
                                 "data/federated.py", "configs/base.py"])
def test_framework_free_copies_are_byte_equal(rel):
    assert (SRC / "repro_torch" / rel).read_bytes() == (SRC / "repro" / rel).read_bytes()


@pytest.mark.parametrize("name", ["RESNET9_CIFAR100", "RESNET18_CIFAR10", "SMALL_CNN"])
def test_resnet_configs_equal(name):
    assert (dataclasses.asdict(getattr(t_configs, name))
            == dataclasses.asdict(getattr(j_configs, name)))


def test_data_partition_and_round_sampling_bitwise():
    ji, jl = j_images(300, 10, 16, seed=3)
    ti, tl = t_images(300, 10, 16, seed=3)
    assert np.array_equal(ji, ti) and np.array_equal(jl, tl)
    for jp, tp in ((j_dirichlet(jl, 6, 0.07, seed=3), t_dirichlet(tl, 6, 0.07, seed=3)),
                   (j_pathological(jl, 6, 20, seed=3), t_pathological(tl, 6, 20, seed=3))):
        assert all(np.array_equal(a, b) for a, b in zip(jp, tp))
    jd = JData.from_partition(ji, jl, j_dirichlet(jl, 6, 0.07, seed=3), seed=3)
    td = TData.from_partition(ti, tl, t_dirichlet(tl, 6, 0.07, seed=3), seed=3)
    jr, tr = np.random.RandomState(5), np.random.RandomState(5)
    ids = [jr.choice(6, 3, replace=False), tr.choice(6, 3, replace=False)]
    assert np.array_equal(*ids)
    jb = jd.sample_round_batches(jr, ids[0], 2, 4)
    tb = td.sample_round_batches(tr, ids[1], 2, 4)
    for k in ("images", "labels"):
        assert np.array_equal(jb[k], tb[k])
    for k in ("images", "labels", "mask"):
        assert np.array_equal(jd.client_test_set(ids[0])[k], td.client_test_set(ids[1])[k])


@pytest.mark.parametrize("k", [1, 3, 4, 5, 8])
def test_ordered_axis_sum_and_cohort_mean_bitwise(k):
    x = (np.random.RandomState(k).randn(k, 37, 5) * 10.0 ** np.arange(5)).astype(np.float32)
    assert np.array_equal(np.asarray(j_ordered_axis_sum(jnp.asarray(x))),
                          ordered_axis_sum(torch.from_numpy(x)).numpy())
    tree = {"a": x, "b": (x[:, 0] * 3.0).astype(np.float32)}
    j_mean = j_cohort_mean(jax.tree.map(jnp.asarray, tree))
    t_mean = cohort_mean(params_from_jax(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(j_mean), tree_leaves(t_mean)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_flat_layout_matches_jax_leaf_order():
    jp = jax.jit(j_cnn.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     j_configs.SMALL_CNN)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    layout = FlatLayout(tp)
    flat = layout.flatten(tp)
    assert flat.shape == (layout.size,)
    assert np.array_equal(flat.numpy(), np.asarray(tree_flatten_to_vector(jp)))
    # round trip, structure included (blocks stays a tuple)
    back = layout.unflatten(flat)
    assert isinstance(back["blocks"], tuple)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(params_to_numpy(back))):
        assert a.shape == b.shape and np.array_equal(np.asarray(a), b)
    # a stacked (C, N) block unflattens into (C, *leaf) views
    stacked = layout.unflatten(torch.stack([flat, 2 * flat]))
    assert torch.equal(stacked["stem"][1], 2 * tp["stem"])


def test_tree_helpers_leave_no_reference_cycle():
    """Flattening, unflattening and mapping a tree hold its leaves only as
    long as their results: with the cyclic collector off, a leaf dies with
    its last reference (at LM width a tree is GBs of device memory)."""
    import gc
    import weakref

    from repro_torch.utils.pytree import (tree_flatten, tree_flatten_with_path, tree_map,
                                          tree_unflatten)

    tree = {"a": (torch.ones(3), {"b": torch.zeros(2)}), "c": [torch.ones(4)]}
    refs = [weakref.ref(x) for x in tree_leaves(tree)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        leaves, treedef = tree_flatten(tree)
        back = tree_unflatten(treedef, leaves)
        tree_flatten_with_path(back)
        layout = FlatLayout(back)
        layout.unflatten(layout.flatten(tree_map(lambda x: x * 2, back)))
        del tree, leaves, back
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_repro():
    """Every module of the port, the multi-device slice's among them, and
    ``chip_smoke.py``."""
    paths = sorted((SRC / "repro_torch").rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    names = {str(p.relative_to(SRC.parent)) for p in paths}
    assert {"chip_smoke.py", "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/dryrun.py", "src/repro_torch/launch/collectives.py",
            "src/repro_torch/fl/engine.py"} <= names
    bad = []
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(SRC.parent)}: {mod}")
    assert not bad, bad


_NO_JAX_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.configs.resnet_cifar import SMALL_CNN as CFG
from repro_torch.core.baselines import PFedSOP
from repro_torch.data import FederatedData, dirichlet_partition, make_class_conditional_images
from repro_torch.fl import Federation, FLRunConfig, masked_accuracy
from repro_torch.models import cnn
images, labels = make_class_conditional_images(80, CFG.n_classes, CFG.cnn_image_size, seed=0)
data = FederatedData.from_partition(images, labels, dirichlet_partition(labels, 4, 0.5, seed=0))
params = cnn.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
fed = Federation(PFedSOP(), lambda p, b: cnn.loss_fn(p, CFG, b),
                 masked_accuracy(lambda p, t: cnn.apply(p, CFG, t["images"])),
                 params, data, FLRunConfig(n_clients=4, participation=0.5, rounds=1,
                                           batch=8, local_iters=1), device="cpu")
h = fed.run()
assert np.isfinite(h["loss"][0]) and "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("OK")
"""


def test_port_imports_and_runs_a_round_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], capture_output=True,
                         text=True, timeout=240, env={"PYTHONPATH": str(SRC),
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr


def test_entry_points_default_to_the_card():
    from repro_torch.core.baselines import FedAvg
    from repro_torch.fl import Federation, FLRunConfig
    from repro_torch.models import cnn

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        cnn.init_params(torch.Generator(), t_configs.SMALL_CNN)
    images, labels = t_images(40, 10, 16, seed=0)
    data = TData.from_partition(images, labels, t_dirichlet(labels, 4, 0.5, seed=0))
    params = cnn.init_params(torch.Generator(), t_configs.SMALL_CNN, device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Federation(FedAvg(), None, None, params, data, FLRunConfig(n_clients=4))
