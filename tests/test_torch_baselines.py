"""The paper's baselines and the optimizers of the port against ``repro``.

Every method of ``repro``'s ``METHODS``, plus the no-PC pFedSOP ablation,
SCAFFOLD and FedExP, runs the same 3-round sync history in both packages
(``SMALL_CNN``, K = 8, participation 0.5, the same numpy data, init and
cohorts; ``repro`` on its ``VmapBackend`` with its Pallas update kernel
in interpret mode, the port with its kernels' plain versions on the CPU).

Tolerances: the loss to rtol 1e-5 and the accuracy to 1e-6, as
``tests/test_torch_pfedsop.py`` holds pfedsop (XLA:CPU and oneDNN
convolutions sum in another f32 order, carried through 3 rounds of SGD);
the optimizers and the schedule to rtol 1e-6 (elementwise f32, one step);
the FedRep mask and the staleness weights at tau = 0 exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet_cifar import SMALL_CNN as J_CFG
from repro.core import baselines as j_bl
from repro.core import pfedsop as j_pf
from repro.data import FederatedData as JData
from repro.data import dirichlet_partition, make_class_conditional_images
from repro.fl import Federation as JFederation, FLRunConfig as JRunConfig
from repro.fl.runtime import masked_accuracy as j_masked_accuracy
from repro.models import cnn as j_cnn
from repro.utils.pytree import tree_flatten_to_vector
from repro_torch.configs.resnet_cifar import SMALL_CNN as T_CFG
from repro_torch.core import baselines as t_bl
from repro_torch.core import pfedsop as t_pf
from repro_torch.data import FederatedData as TData
from repro_torch.fl import Federation as TFederation, FLRunConfig as TRunConfig
from repro_torch.fl import masked_accuracy as t_masked_accuracy
from repro_torch.models import cnn as t_cnn
from repro_torch.optim import sgd as t_sgd
from repro_torch.utils.pytree import FlatLayout
from repro_torch.weights import params_from_jax

# the module (``repro.optim`` re-exports the function ``sgd`` under its name)
j_sgd = importlib.import_module("repro.optim.sgd")

HEAD = lambda p: "fc_" in p  # examples/train_federated.py's FedRep head

ALL_METHODS = sorted(j_bl.METHODS) + ["pfedsop_nopc"]


def _method(pkg, name):
    bl, pf = (j_bl, j_pf) if pkg == "repro" else (t_bl, t_pf)
    if name == "fedrep":
        return bl.FedRep(lr=0.05, head_predicate=HEAD)
    if name.startswith("pfedsop"):
        impl = {"repro": "kernel_interpret", "port": "auto"}[pkg]
        cfg = pf.PFedSOPConfig(eta1=0.05, eta2=0.05, use_pc=name == "pfedsop",
                               update_impl=impl)
        return bl.PFedSOP(cfg=cfg, name=name)
    if name in ("fedprox", "fedprox_ft"):
        return bl.METHODS[name](lr=0.05, mu=0.3)
    if name == "ditto":
        return bl.Ditto(lr=0.05, lam=0.3)
    return bl.METHODS[name](lr=0.05)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once, and torch's OpenMP pools of one
    thread per core each make them wait on one another for many times
    the work (the values do not depend on it: every comparison here is
    within one process or to a stated tolerance)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    images, labels = make_class_conditional_images(400, 10, 16, seed=0)
    # from_partition shuffles the index arrays it is given in place, so
    # each package gets its own copy of the partition
    parts = lambda: dirichlet_partition(labels, 8, alpha=0.07, seed=0)
    jp = jax.jit(j_cnn.init_params, static_argnums=1)(jax.random.PRNGKey(0), J_CFG)
    return {
        "jdata": JData.from_partition(images, labels, parts(), seed=0),
        "tdata": TData.from_partition(images, labels, parts(), seed=0),
        "jp": jp,
        "tp": params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
    }


def test_method_table_matches_repro():
    assert sorted(t_bl.METHODS) == sorted(j_bl.METHODS)
    for name, cls in t_bl.METHODS.items():
        assert cls().name == j_bl.METHODS[name]().name


@pytest.mark.parametrize("name", ALL_METHODS)
def test_three_round_history_matches_repro(setup, name):
    s = setup
    kw = dict(n_clients=8, participation=0.5, rounds=3, batch=16, local_iters=2, seed=0)
    j_hist = JFederation(
        _method("repro", name), lambda p, b: j_cnn.loss_fn(p, J_CFG, b),
        j_masked_accuracy(lambda p, t: j_cnn.apply(p, J_CFG, t["images"])),
        s["jp"], s["jdata"], JRunConfig(**kw)).run()
    t_hist = TFederation(
        _method("port", name), lambda p, b: t_cnn.loss_fn(p, T_CFG, b),
        t_masked_accuracy(lambda p, t: t_cnn.apply(p, T_CFG, t["images"])),
        s["tp"], s["tdata"], TRunConfig(**kw), device="cpu").run()
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(t_hist["acc"], j_hist["acc"], rtol=0, atol=1e-6)
    assert t_hist["sim_time"] == j_hist["sim_time"] == [1.0, 2.0, 3.0]
    assert t_hist["mean_best_acc"] == pytest.approx(j_hist["mean_best_acc"], abs=1e-6)


def test_fedrep_head_mask_matches_repro_leaf_by_leaf(setup):
    s = setup
    j_head, j_body = j_bl.FedRep(head_predicate=HEAD)._masks(s["jp"])
    layout = FlatLayout(s["tp"])
    mask = t_bl.FedRep(head_predicate=HEAD, layout=layout).head_mask()
    want = np.asarray(tree_flatten_to_vector(
        jax.tree.map(lambda m, p: jnp.broadcast_to(m, p.shape), j_head, s["jp"])))
    assert mask.dtype == torch.float32 and np.array_equal(mask.numpy(), want)
    assert 0 < mask.sum() < mask.numel()  # fc_w and fc_b only
    j_paths = ["/".join(str(k) for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(s["jp"])[0]]
    assert layout.paths == j_paths


def _grad_pair(seed):
    rng = np.random.RandomState(seed)
    tree = {"w": rng.randn(7, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    return jax.tree.map(jnp.asarray, tree), {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov", "adam", "adam_wd",
                                 "adam_cosine"])
def test_optimizer_matches_repro(opt):
    make = {
        "sgd": lambda m: m.sgd(0.1),
        "momentum": lambda m: m.momentum(0.1, 0.9),
        "nesterov": lambda m: m.momentum(0.1, 0.9, nesterov=True),
        "adam": lambda m: m.adam(0.01),
        "adam_wd": lambda m: m.adam(0.01, weight_decay=0.1),
        "adam_cosine": lambda m: m.adam(m.cosine_schedule(0.01, 2, 6)),
    }[opt]
    j_init, j_update = make(j_sgd)
    t_init, t_update = make(t_sgd)
    jp, tp = _grad_pair(0)
    js, ts = j_init(jp), t_init(tp)
    for step in range(4):
        jg, tg = _grad_pair(step + 1)
        ju, js = j_update(jg, js, jp)
        tu, ts = t_update(tg, ts, tp)
        jp, tp = j_sgd.apply_updates(jp, ju), t_sgd.apply_updates(tp, tu)
        for k in ("w", "b"):
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6)


def test_cosine_schedule_matches_repro():
    j, t = j_sgd.cosine_schedule(0.3, 5, 40), t_sgd.cosine_schedule(0.3, 5, 40)
    steps = np.arange(0, 50, dtype=np.int32)
    np.testing.assert_allclose(t(torch.from_numpy(steps)).numpy(),
                               np.asarray(j(jnp.asarray(steps))), rtol=1e-6, atol=1e-9)


def test_staleness_weights_mean_one_and_exact_when_fresh():
    tau = np.array([0, 1, 3, 7, 0, 2], np.int32)
    w = t_bl.staleness_weights(torch.from_numpy(tau), 0.5)
    np.testing.assert_allclose(w.numpy(),
                               np.asarray(j_bl.staleness_weights(jnp.asarray(tau), 0.5)),
                               rtol=1e-6)
    assert float(w.mean()) == pytest.approx(1.0, abs=1e-6)
    fresh = t_bl.staleness_weights(torch.zeros(5, dtype=torch.int32), 0.5)
    assert fresh.dtype == torch.float32 and torch.equal(fresh, torch.ones(5))
    assert float(t_pf.staleness_discount(torch.tensor(0), 0.7)) == 1.0


def test_fedexp_step_is_a_tensor_clamp():
    """eta_g = max(1, ...) as a tensor clamp: a cohort of identical deltas
    gives eta_g exactly 1 (no extrapolation), spread deltas more."""
    m = t_bl.FedExP(eps=1e-3)
    x = torch.zeros(6)
    same = torch.ones(4, 6)
    assert torch.equal(m.server_update(x, same), -torch.ones(6))
    spread = torch.tensor([[1.0] * 6, [-1.0] * 6, [1.0] * 6, [-0.5] * 6])
    mean_d = spread.mean(0)
    eta = (spread.pow(2).sum() / (2 * 4 * (mean_d.pow(2).sum() + 1e-3))).item()
    assert eta > 1
    np.testing.assert_allclose(m.server_update(x, spread).numpy(), (-eta * mean_d).numpy(),
                               rtol=1e-6)
