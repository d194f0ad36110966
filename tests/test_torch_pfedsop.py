"""pFedSOP math and the whole slice (``Federation`` with pfedsop and
fedavg on ``VmapBackend``) against ``repro``.

``repro`` runs with its Pallas update kernel in interpret mode; the port
runs with ``update_impl="auto"``, which on the CPU takes the kernels'
plain versions through the same wrappers the card uses.

Tolerances: the pFedSOP scalars and steps to rtol 1e-5 (f32 sums over
the flat vector vs per-leaf partial sums).  The 3-round histories to
rtol 1e-5 on the loss and 1e-6 on the accuracy, and the stored client
params to 1e-5 absolute: XLA:CPU and oneDNN convolutions differ in f32
summation order, and three rounds of SGD carry that noise forward.
"""
import dataclasses

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
from repro_torch.kernels.pfedsop_update import ops
from repro_torch.launch import train_federated
from repro_torch.models import cnn as t_cnn
from repro_torch.utils.pytree import FlatLayout
from repro_torch.weights import params_from_jax


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": (scale * rng.randn(33, 17)).astype(np.float32),
            "b": (scale * rng.randn(9)).astype(np.float32)}


def _pair(tree):
    """(repro pytree, port flat vector) of one numpy tree."""
    j = jax.tree.map(jnp.asarray, tree)
    return j, torch.from_numpy(np.array(tree_flatten_to_vector(j)))


@pytest.mark.parametrize("kind", ["random", "aligned", "opposed", "zero"])
def test_gompertz_weight_matches_repro(kind):
    jl, tl = _pair(_tree(0, 0.1))
    other = {"random": _tree(1, 0.2), "aligned": _tree(0, 0.3),
             "opposed": _tree(0, -0.3), "zero": _tree(0, 0.0)}[kind]
    jg, tg = _pair(other)
    jb, jaux = j_pf.gompertz_weight(jl, jg, 0.8)
    tb, taux = t_pf.gompertz_weight(tl, tg, 0.8)
    sim = float(jaux["sim"])
    np.testing.assert_allclose(float(taux["sim"]), sim, rtol=1e-5, atol=1e-7)
    # arccos is ill-conditioned at sim = +-1: |d theta| <= sqrt(2 |d sim|);
    # |d beta / d theta| <= lam / e < 1
    tol = np.sqrt(2 * 2e-7) if abs(sim) > 0.999 else 1e-6
    np.testing.assert_allclose(float(taux["theta"]), float(jaux["theta"]), rtol=1e-5, atol=tol)
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-5, atol=tol)
    b = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    assert np.array_equal(t_pf.theta_from_beta(b, 0.8), j_pf.theta_from_beta(b, 0.8))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 131.0])
def test_sherman_morrison_step_form_to_form(scale):
    """The explicit two-term form in both packages.  Its coefficient
    1/rho - sq/(rho^2 + rho sq) cancels to ~1/(rho + sq), so one ulp of
    1/rho in the difference is the error floor: atol 4 ulp(1/rho) max|dp|."""
    jd, td = _pair(_tree(2, scale))
    want = np.asarray(tree_flatten_to_vector(j_pf.sherman_morrison_step(jd, 1.3)))
    got = t_pf.sherman_morrison_step(td, 1.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=4 * 2.0 ** -23 / 1.3 * np.abs(td.numpy()).max())


@pytest.mark.parametrize("use_pc", [True, False])
@pytest.mark.parametrize("impl", ["reference", "auto"])
def test_personalize_matches_repro(impl, use_pc):
    jx, tx = _pair(_tree(3))
    jl, tl = _pair(_tree(4, 0.1))
    jg, tg = _pair(_tree(5, -0.05))
    jcfg = j_pf.PFedSOPConfig(eta1=0.02, rho=1.3, lam=0.8, use_pc=use_pc,
                              update_impl="kernel_interpret" if impl == "auto" else impl)
    tcfg = t_pf.PFedSOPConfig(eta1=0.02, rho=1.3, lam=0.8, use_pc=use_pc, update_impl=impl)
    want, jaux = j_pf.personalize(jx, jl, jg, jcfg)
    got, taux = t_pf.personalize(tx, tl, tg, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(tree_flatten_to_vector(want)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(taux["beta"]), float(jaux["beta"]), rtol=1e-5)
    # a cohort: one batched call, the same rows
    cohort, aux = t_pf.personalize(torch.stack([tx, tx]), torch.stack([tl, tl]), tg, tcfg)
    assert aux["beta"].shape == (2,) and torch.allclose(cohort[1], got, atol=1e-7)


@pytest.fixture(scope="module")
def small_setup():
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


def test_client_round_matches_repro(small_setup):
    """A cohort of 3 with mixed has_delta: the port's batched round start +
    mapped local SGD against repro's vmapped one-client round."""
    s = small_setup
    jp, tp = s["jp"], s["tp"]
    layout = FlatLayout(tp)
    rng = np.random.RandomState(0)
    batches = s["jdata"].sample_round_batches(rng, np.array([0, 3, 5]), 2, 8)
    noise = [jax.tree.map(lambda x, i=i: 0.01 * jnp.sin(x + i), jp) for i in range(4)]
    has = jnp.asarray([True, False, True])
    j_state = j_pf.ClientState(
        params=jax.tree.map(lambda *xs: jnp.stack(xs), jp, noise[0], jp),
        delta=jax.tree.map(lambda *xs: jnp.stack(xs), *noise[1:]),
        has_delta=has, rounds_seen=jnp.zeros(3, jnp.int32))
    jcfg = j_pf.PFedSOPConfig(eta1=0.05, eta2=0.05, update_impl="kernel_interpret")
    j_loss = lambda p, b: j_cnn.loss_fn(p, J_CFG, b)
    j_new, j_delta, j_m = jax.jit(jax.vmap(
        lambda st, b: j_pf.client_round(j_loss, st, noise[0], jnp.asarray(True), b, jcfg)
    ))(j_state, jax.tree.map(jnp.asarray, batches))

    flat = lambda tree: torch.from_numpy(np.array(jax.vmap(tree_flatten_to_vector)(tree)))
    t_state = t_pf.ClientState(params=flat(j_state.params), delta=flat(j_state.delta),
                               has_delta=torch.tensor([True, False, True]),
                               rounds_seen=torch.zeros(3, dtype=torch.int32))
    tcfg = t_pf.PFedSOPConfig(eta1=0.05, eta2=0.05)
    t_loss = lambda v, b: t_cnn.loss_fn(layout.unflatten(v), T_CFG, b)
    t_new, t_delta, t_m = t_pf.client_round(
        t_loss, t_state, flat(jax.tree.map(lambda x: x[None], noise[0]))[0],
        torch.tensor(True), {k: torch.from_numpy(v) for k, v in batches.items()}, tcfg)

    assert t_m["personalized"].tolist() == [True, False, True]
    np.testing.assert_allclose(t_m["beta"].numpy()[[0, 2]],
                               np.asarray(j_m["beta"])[[0, 2]], rtol=1e-5)
    np.testing.assert_allclose(t_m["loss"].numpy(), np.asarray(j_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(t_new.params.numpy(), flat(j_new.params).numpy(), atol=1e-5)
    np.testing.assert_allclose(t_delta.numpy(), flat(j_delta).numpy(), atol=1e-3)
    assert t_new.rounds_seen.tolist() == [1, 1, 1] and bool(t_new.has_delta.all())


def _record_cohorts(monkeypatch, cls, log):
    orig = cls.client_test_set

    def client_test_set(self, client_ids):
        log.append(np.asarray(client_ids))
        return orig(self, client_ids)

    monkeypatch.setattr(cls, "client_test_set", client_test_set)


@pytest.mark.parametrize("method", ["pfedsop", "fedavg"])
def test_federation_slice_matches_repro(small_setup, method, monkeypatch):
    s = small_setup
    kw = dict(n_clients=8, participation=0.5, rounds=3, batch=16, local_iters=2, seed=0)
    j_ids, t_ids = [], []
    _record_cohorts(monkeypatch, JData, j_ids)
    _record_cohorts(monkeypatch, TData, t_ids)
    if method == "pfedsop":
        j_method, t_method = j_bl.PFedSOP(), t_bl.PFedSOP()
        j_run = JRunConfig(update_impl="kernel_interpret", **kw)
    else:
        j_method, t_method = j_bl.FedAvg(), t_bl.FedAvg()
        j_run = JRunConfig(**kw)
    j_fed = JFederation(j_method, lambda p, b: j_cnn.loss_fn(p, J_CFG, b),
                        j_masked_accuracy(lambda p, t: j_cnn.apply(p, J_CFG, t["images"])),
                        s["jp"], s["jdata"], j_run)
    j_hist = j_fed.run()
    t_fed = TFederation(t_method, lambda p, b: t_cnn.loss_fn(p, T_CFG, b),
                        t_masked_accuracy(lambda p, t: t_cnn.apply(p, T_CFG, t["images"])),
                        s["tp"], s["tdata"], TRunConfig(**kw), device="cpu")
    t_hist = t_fed.run()

    assert len(j_ids) == len(t_ids) == 3
    for a, b in zip(j_ids, t_ids):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(t_hist["acc"], j_hist["acc"], rtol=0, atol=1e-6)
    assert t_hist["sim_time"] == j_hist["sim_time"] == [1.0, 2.0, 3.0]
    assert t_hist["mean_best_acc"] == pytest.approx(j_hist["mean_best_acc"], abs=1e-6)
    if method == "pfedsop":
        want = np.asarray(jax.vmap(tree_flatten_to_vector)(j_fed.client_states.params))
        got = t_fed.client_states.params.numpy()
    else:
        want = np.asarray(tree_flatten_to_vector(j_fed.broadcast))
        got = t_fed.broadcast.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert ops.LAUNCHES == {"reduce3": 0, "update": 0}  # plain versions on the CPU


@pytest.mark.parametrize("knob", ["shards", "mesh", "output_sharding", "grad_chunks",
                                  "ckpt_every", "ckpt_dir", "async_cfg", "obs"])
def test_unported_run_knobs_raise(knob):
    """The multi-device knobs still raise; checkpointing, async and obs are
    ported now and are accepted as given."""
    value = {"shards": 2, "mesh": "pods:2x2x2", "output_sharding": "sharded",
             "grad_chunks": 2, "ckpt_every": 5, "ckpt_dir": "ck",
             "async_cfg": object(), "obs": {"trace_dir": "t"}}[knob]
    if knob in ("ckpt_every", "ckpt_dir", "async_cfg", "obs"):
        assert getattr(TRunConfig(**{knob: value}), knob) is value
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TRunConfig(**{knob: value})


@pytest.mark.parametrize("case", ["backend", "store", "availability", "impl"])
def test_unported_federation_options_raise(small_setup, case):
    s = small_setup
    run = dict(n_clients=8, rounds=1)
    extra = {}
    if case == "backend":
        run["backend"] = "shard_map"
    elif case == "store":
        run["store"] = "host"
    elif case == "availability":
        extra["availability"] = object()
    else:
        run["update_impl"] = "kernel_interpret"
    # an availability model is ported now: an object that is none is refused
    err = {"impl": ValueError, "availability": TypeError}.get(case, NotImplementedError)
    with pytest.raises(err):
        TFederation(t_bl.PFedSOP(), None, None, s["tp"], s["tdata"],
                    TRunConfig(**run), device="cpu", **extra)


def test_cli_runs_both_methods_on_the_cpu(capsys):
    results = train_federated.main([
        "--device", "cpu", "--rounds", "1", "--samples", "200", "--clients", "4",
        "--participation", "0.5", "--update-impl", "reference"])
    assert set(results) == {"pfedsop", "fedavg"}
    assert all(np.isfinite(h["loss"][0]) for h in results.values())
    assert "mean best acc" in capsys.readouterr().out


def test_reference_impl_override_reaches_the_method():
    from repro_torch.fl.runtime import override_update_impl

    m = override_update_impl(t_bl.PFedSOP(), "reference")
    assert m.cfg.update_impl == "reference" and dataclasses.is_dataclass(m.cfg)
    with pytest.raises(ValueError, match="no update_impl knob"):
        override_update_impl(t_bl.FedAvg(), "reference")
