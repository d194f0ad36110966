"""The port's async federation against ``repro`` and against its own sync
driver.

- ``fl/availability.py`` is a byte-equal copy of ``repro``'s, and
  ``fl/scheduler.py`` differs only in its two import lines.
- The degenerate configuration (everyone always online at uniform speed,
  concurrency = buffer = K') equals the port's synchronous history bit for
  bit, and every method's ``server_update_stale`` at tau = 0 equals its
  ``server_update`` bit for bit.
- ``stale_blend`` to rtol 1e-6 of ``repro``'s (elementwise f32 after a
  dot product over N).
- The heterogeneous run (``repro``'s ``HETERO``: lognormal speeds, 30 %
  availability) against ``repro``: the ``sim_time`` and staleness
  sequences exactly equal (host numpy in both); loss and accuracy to
  rtol 1e-5 (f32 convolutions in another summation order, as in
  ``tests/test_torch_pfedsop.py``).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_async_federation import HETERO as J_HETERO

from repro.configs.resnet_cifar import SMALL_CNN as J_CFG
from repro.core import baselines as j_bl
from repro.core import pfedsop as j_pf
from repro.data import FederatedData as JData
from repro.data import dirichlet_partition, make_class_conditional_images
from repro.fl import AsyncConfig as JAsyncConfig, AsyncFederation as JAsync
from repro.fl import FLRunConfig as JRunConfig
from repro.fl.runtime import masked_accuracy as j_masked_accuracy
from repro.models import cnn as j_cnn
from repro_torch.configs.resnet_cifar import SMALL_CNN as T_CFG
from repro_torch.core import baselines as t_bl
from repro_torch.core import pfedsop as t_pf
from repro_torch.data import FederatedData as TData
from repro_torch.fl import AsyncConfig, AsyncFederation, AvailabilityConfig, Federation
from repro_torch.fl import FLRunConfig, masked_accuracy
from repro_torch.kernels.pfedsop_update import ops
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.pytree import tree_leaves
from repro_torch.weights import params_from_jax

SRC = Path(__file__).resolve().parents[1] / "src"
HETERO = AvailabilityConfig(**dataclasses.asdict(J_HETERO))
METHOD_NAMES = sorted(t_bl.METHODS) + ["scaffold", "fedexp"]


def _method(bl, name):
    if name == "fedrep":
        return bl.FedRep(head_predicate=lambda p: "fc_" in p)
    return bl.METHODS[name]()


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
    """``tests/test_async_federation.py``'s setup: 800 samples, K = 8,
    Dir(0.3)."""
    images, labels = make_class_conditional_images(800, 10, 16, seed=0)
    parts = lambda: dirichlet_partition(labels, 8, alpha=0.3, seed=0)
    jp = jax.jit(j_cnn.init_params, static_argnums=1)(jax.random.PRNGKey(0), J_CFG)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    t_loss = lambda p, b: t_cnn.loss_fn(p, T_CFG, b)
    t_acc = masked_accuracy(lambda p, t: t_cnn.apply(p, T_CFG, t["images"]))
    return {
        "j": (JData.from_partition(images, labels, parts(), seed=0), jp,
              lambda p, b: j_cnn.loss_fn(p, J_CFG, b),
              j_masked_accuracy(lambda p, t: j_cnn.apply(p, J_CFG, t["images"]))),
        "t": (TData.from_partition(images, labels, parts(), seed=0), tp, t_loss, t_acc),
    }


def _cfg(cls=FLRunConfig, rounds=3):
    return cls(n_clients=8, participation=0.5, rounds=rounds, batch=8, local_iters=2,
               seed=1)


def _port_run(setup, method, async_cfg=None, driver=AsyncFederation, rounds=3):
    data, params, loss, acc = setup["t"]
    if driver is Federation:
        return Federation(method, loss, acc, params, data, _cfg(rounds=rounds),
                          device="cpu").run()
    return driver(method, loss, acc, params, data, _cfg(rounds=rounds), async_cfg,
                  device="cpu").run()


def test_availability_is_a_byte_equal_copy():
    assert ((SRC / "repro_torch/fl/availability.py").read_bytes()
            == (SRC / "repro/fl/availability.py").read_bytes())


def test_scheduler_differs_only_in_its_imports():
    ours = (SRC / "repro_torch/fl/scheduler.py").read_text().splitlines()
    theirs = (SRC / "repro/fl/scheduler.py").read_text().splitlines()
    assert len(ours) == len(theirs)
    diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert diff == [
        ("from repro_torch.fl.availability import AvailabilityModel",
         "from repro.fl.availability import AvailabilityModel"),
        ("from repro_torch.obs import NOOP", "from repro.obs import NOOP"),
    ]


@pytest.mark.parametrize("name", ["pfedsop", "fedavg"])
def test_degenerate_async_equals_sync_bitwise(setup, name):
    sync = _port_run(setup, _method(t_bl, name), driver=Federation)
    asyn = _port_run(setup, _method(t_bl, name))
    for key in ("loss", "acc", "sim_time"):
        assert asyn[key] == sync[key], key
    assert asyn["mean_best_acc"] == sync["mean_best_acc"]
    assert asyn["staleness"] == [0.0, 0.0, 0.0]
    assert asyn["engine"]["cohort_sizes"] == [4]


def _uploads_for(method, n, b, seed):
    """A broadcast and a (b, n) upload stack of ``method``'s structure, with
    some -0.0 entries (a +0.0 in their place would show a non-bitwise path)."""
    g = torch.Generator().manual_seed(seed)
    params = torch.randn(n, generator=g)
    rows = torch.randn(b, n, generator=g)
    rows[:, ::7] = -0.0
    if isinstance(method, t_bl.PFedSOP):
        broadcast = {"delta": torch.randn(n, generator=g), "has_delta": torch.tensor(True)}
        return broadcast, rows
    if isinstance(method, t_bl.Scaffold):
        broadcast = method.init_server(params)
        return broadcast, {"y": rows, "dc": torch.randn(b, n, generator=g)}
    return method.init_server(params), rows


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", METHOD_NAMES)
def test_stale_hook_at_tau_zero_is_server_update_bitwise(name):
    m = _method(t_bl, name)
    broadcast, ups = _uploads_for(m, 301, 3, 0)
    plain = m.server_update(broadcast, ups)
    stale = m.server_update_stale(broadcast, ups, torch.zeros(3, dtype=torch.int32))
    for a, b in zip(tree_leaves(plain), tree_leaves(stale)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_stale_blend_matches_repro_and_passes_fresh_uploads():
    rng = np.random.RandomState(0)
    up = rng.randn(4, 257).astype(np.float32)
    up[:, ::5] = -0.0
    glob = rng.randn(257).astype(np.float32)
    tau = np.array([0, 1, 4, 9], np.int32)
    s_t = t_pf.staleness_discount(torch.from_numpy(tau), 0.5)
    s_j = j_pf.staleness_discount(jnp.asarray(tau), 0.5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    got = t_pf.stale_blend(torch.from_numpy(up), torch.from_numpy(glob), s_t, 0.8)
    want = jax.vmap(lambda u, s: j_pf.stale_blend(u, jnp.asarray(glob), s, 0.8))(
        jnp.asarray(up), s_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.array_equal(got[0].numpy().view(np.int32), up[0].view(np.int32))


@pytest.mark.parametrize("name", ["pfedsop", "fedavg", "scaffold"])
def test_heterogeneous_async_matches_repro(setup, name):
    jdata, jp, jloss, jacc = setup["j"]
    j_hist = JAsync(_method(j_bl, name), jloss, jacc, jp, jdata,
                    _cfg(JRunConfig, rounds=4), JAsyncConfig(availability=J_HETERO)).run()
    t_hist = _port_run(setup, _method(t_bl, name), AsyncConfig(availability=HETERO),
                       rounds=4)
    assert t_hist["sim_time"] == j_hist["sim_time"]
    assert t_hist["staleness"] == j_hist["staleness"]
    assert any(t_hist["staleness"])  # the run really applies stale uploads
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(t_hist["acc"], j_hist["acc"], rtol=1e-5)
    assert t_hist["engine"]["cohort_sizes"] == j_hist["engine"]["cohort_sizes"]


def test_each_pfedsop_dispatch_is_one_update_pair(setup, monkeypatch):
    """One batched round-start call (K1 + K2 on the card) per dispatched
    micro-cohort, at the cohort's size C, whatever C is."""
    calls, dispatched = [], []
    orig_reduce, orig_dispatch = ops.reduce3_batched, AsyncFederation._dispatch
    monkeypatch.setattr(ops, "reduce3_batched",
                        lambda d_i, d_g: calls.append(d_i.shape[0]) or orig_reduce(d_i, d_g))
    monkeypatch.setattr(AsyncFederation, "_dispatch",
                        lambda self, ids: dispatched.append(len(ids)) or orig_dispatch(self, ids))
    hist = _port_run(setup, t_bl.PFedSOP(), AsyncConfig(buffer_size=2, availability=HETERO),
                     rounds=4)
    assert calls == dispatched and len(set(calls)) > 1
    assert sorted(set(calls)) == hist["engine"]["cohort_sizes"]
