"""The LM slice (dense decoder + per-client pFedSOP) against ``repro``.

Whole-stack loss and grads, and a 3-round federated history, with
``repro``'s initialization carried across.  ``repro`` runs as its own
tests run it: "reference", or its Pallas kernels in interpret mode; the
port runs "reference" or "auto" (on the CPU, the plain versions of its
CUDA kernels).

Tolerances: whole-stack loss rtol 1e-6 and grads rtol 5e-4 / atol 1e-5,
the JAX package's own impl-parity tolerances
(tests/test_model_dispatch.py); f32 sums in another order in another
framework stay inside them (measured loss <= 2e-7 relative, grads
<= 2e-6 of the largest entry).  The 3-round history: rtol 1e-4, f32
noise carried through 12 SGD steps and two personalized updates.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import pfedsop as j_pf
from repro.models import transformer as j_tf
from repro_torch.configs import get_config
from repro_torch.core import pfedsop as t_pf
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.kernels.pfedsop_update import ops as update_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import train_lm_pfedsop as driver
from repro_torch.models import transformer as t_tf
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax, params_to_numpy

SRC = Path(__file__).resolve().parents[1] / "src"
# the dense archs; tests/test_torch_archs.py holds the other six
DENSE_ARCHS = ("gemma3-1b", "granite-3-2b", "granite-3-8b", "gemma2-9b")


# -- copies and registry ---------------------------------------------------


def test_lm_data_copy_is_byte_equal():
    assert (SRC / "repro_torch/data/lm.py").read_bytes() == (SRC / "repro/data/lm.py").read_bytes()


@pytest.mark.parametrize("mod", ["gemma3_1b", "gemma2_9b", "granite_3_2b", "granite_3_8b"])
def test_arch_config_copies_differ_only_in_the_import_line(mod):
    a = (SRC / "repro/configs" / f"{mod}.py").read_text()
    b = (SRC / "repro_torch/configs" / f"{mod}.py").read_text()
    assert b == a.replace("from repro.configs.base import", "from repro_torch.configs.base import")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_dense_configs_equal_repro(arch, reduced):
    assert (dataclasses.asdict(get_config(arch, reduced=reduced))
            == dataclasses.asdict(j_get_config(arch, reduced=reduced)))


# -- weights ---------------------------------------------------------------


def test_bf16_transformer_tree_round_trips_bit_for_bit():
    cfg = j_get_config("gemma3-1b", reduced=True).replace(dtype="bfloat16")
    jp = j_tf.init_params(jax.random.PRNGKey(3), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert isinstance(tp["pattern"], tuple) and len(tp["pattern"]) == len(cfg.pattern)
    assert tp["pattern"][0]["attn"]["wq"].shape[0] == cfg.n_rep
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        assert np.array_equal(b.view(torch.int16).numpy(), np.asarray(a).view(np.int16))
    back = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                        jax.tree.unflatten(jax.tree.structure(jp),
                                           tree_leaves(params_to_numpy(tp))))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a).view(np.int16), np.asarray(b).view(np.int16))


# -- whole stack -----------------------------------------------------------

# (name, arch, config edits): gemma3 at its smoke width (window 512 > S:
# unpruned), with its windows shrunk to 16 and 16-row q blocks (repro's
# kernel grid pruned), gemma2 (attention and final softcaps), granite.
STACKS = [
    ("gemma3", "gemma3-1b", {}),
    ("gemma3-window16", "gemma3-1b", {"window": 16, "attn_q_block": 16}),
    ("gemma2", "gemma2-9b", {}),
    ("granite", "granite-3-2b", {}),
]


def _configs(arch, edits):
    jc, tc = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    if "window" in edits:
        w = edits["window"]
        shrink = lambda c: c.replace(  # noqa: E731
            pattern=tuple(s.replace(window=w) if s.window else s for s in c.pattern),
            attn_q_block=edits["attn_q_block"])
        jc, tc = shrink(jc), shrink(tc)
    return jc, tc


def _batch(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("impls", [("reference", "reference"), ("kernel_interpret", "auto")],
                         ids=["reference", "kernel"])
@pytest.mark.parametrize("name,arch,edits", STACKS, ids=[s[0] for s in STACKS])
def test_whole_stack_loss_and_grads_match_repro(name, arch, edits, impls):
    jc, tc = _configs(arch, edits)
    jc, tc = jc.replace(kernel_impl=impls[0]), tc.replace(kernel_impl=impls[1])
    batch = _batch(jc, 2, 64, seed=1)
    jp = j_tf.init_params(jax.random.PRNGKey(0), jc)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: j_tf.lm_loss(p, jc, jax.tree.map(jnp.asarray, batch)))(jp)

    leaves, treedef = tree_flatten(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    t_loss = t_tf.lm_loss(tree_unflatten(treedef, leaves), tc,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-6, atol=1e-7)
    for a, b in zip(t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=1e-5)


def test_launch_count_formula(monkeypatch):
    """``launches_per_step`` (which chip_smoke.py asserts on the card) counts
    what one step calls: on the CPU, the plain versions the wrappers run."""
    # the reduced configs are f32: their flash launches count under f32's keys
    keys = {kind: flash_ops.launch_key(kind, torch.float32)
            for kind in ("fwd", "bwd_dq", "bwd_dkv")}
    calls = {k: 0 for k in ("rmsnorm", *keys.values())}

    def counting(mod, fn, key):
        orig = getattr(mod, fn)

        def wrapped(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, fn, wrapped)

    counting(rms_ops, "rmsnorm_plain", "rmsnorm")
    for kind in ("fwd", "bwd_dq", "bwd_dkv"):
        counting(flash_ops, f"flash_{kind}_plain", keys[kind])
    for remat in ("block", "none"):
        cfg = get_config("gemma3-1b", reduced=True).replace(remat=remat)
        params = t_tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        leaves, treedef = tree_flatten(params)
        leaves = [x.requires_grad_() for x in leaves]
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 16, 0).items()}
        for k in calls:
            calls[k] = 0
        torch.autograd.grad(t_tf.lm_loss(tree_unflatten(treedef, leaves), cfg, batch), leaves)
        assert calls == driver.launches_per_step(cfg), remat


# -- the slice ---------------------------------------------------------------


def _jax_loop(cfg, params, pcfg, clients, rounds, local_iters, batch, seq_len):
    """The loop of examples/train_lm_pfedsop.py, returning its history."""
    iters = driver.client_streams(cfg, clients, batch, seq_len)
    loss_fn = lambda p, b: j_tf.lm_loss(p, cfg, b)  # noqa: E731
    states = [j_pf.init_client_state(params) for _ in range(clients)]
    global_delta = jax.tree.map(jnp.zeros_like, params)
    has_global = jnp.asarray(False)
    round_fn = jax.jit(lambda s, gd, hg, b: j_pf.client_round(loss_fn, s, gd, hg, b, pcfg))
    hist = {"loss": [], "beta": [], "personalized": []}
    for _ in range(rounds):
        deltas, losses, betas, pers = [], [], [], []
        for i in range(clients):
            bs = [next(iters[i]) for _ in range(local_iters)]
            batches = jax.tree.map(lambda *xs: jnp.stack(xs), *bs)
            states[i], delta, m = round_fn(states[i], global_delta, has_global, batches)
            deltas.append(delta)
            losses.append(float(m["loss"]))
            betas.append(float(m["beta"]))
            pers.append(bool(m["personalized"]))
        global_delta = j_pf.server_aggregate(jax.tree.map(lambda *xs: jnp.stack(xs), *deltas))
        has_global = jnp.asarray(True)
        hist["loss"].append(float(np.mean(losses)))
        hist["beta"].append(float(np.mean(betas)))
        hist["personalized"].append(pers)
    return hist, states


def test_federated_lm_history_matches_repro():
    """2 clients, 2 local iterations, 3 rounds of the port's driver on
    gemma3-1b-smoke (fused update, plain kernel versions) against the
    example's loop in repro (reference update and model: the same f32
    math, summed in another order)."""
    kw = dict(clients=2, rounds=3, local_iters=2, batch=2, seq_len=32)
    jc = j_get_config("gemma3-1b", reduced=True).replace(kernel_impl="reference")
    jp = j_tf.init_params(jax.random.PRNGKey(0), jc)
    j_hist, j_states = _jax_loop(
        jc, jp, j_pf.PFedSOPConfig(eta1=0.1, eta2=0.1, update_impl="reference"), **kw)

    tc = get_config("gemma3-1b", reduced=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    t_hist, t_states = driver.train(tc, tp, t_pf.PFedSOPConfig(eta1=0.1, eta2=0.1), **kw)

    assert j_hist["personalized"] == [[False, False], [True, True], [True, True]]
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-4)
    np.testing.assert_allclose(t_hist["beta"], j_hist["beta"], rtol=1e-4)
    # round 0 reports the zero-information beta; later rounds personalize
    assert abs(t_hist["beta"][0] - 0.4316) < 1e-4
    assert all(abs(b - t_hist["beta"][0]) > 0.05 for b in t_hist["beta"][1:])
    for j_state, t_state in zip(j_states, t_states):
        for a, b in zip(jax.tree.leaves(j_state.params), tree_leaves(t_state.params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5)
    assert update_ops.LAUNCHES == {"reduce3": 0, "update": 0}


def test_tree_round_reference_update_matches_repro():
    """The per-leaf reference round-start update on a bf16 tree, rounding
    the blend and the step to bf16 per leaf as repro does."""
    cfg = j_get_config("gemma3-1b", reduced=True).replace(dtype="bfloat16")
    jp = j_tf.init_params(jax.random.PRNGKey(1), cfg)
    noise = [jax.tree.map(lambda x, i=i: (0.01 * jnp.sin(x.astype(jnp.float32) + i)
                                          ).astype(x.dtype), jp) for i in range(2)]
    jcfg = j_pf.PFedSOPConfig(eta1=0.05, update_impl="reference")
    want, jaux = j_pf.personalize(jp, noise[0], jax.tree.map(
        lambda x: x.astype(jnp.float32), noise[1]), jcfg)
    to_t = lambda t: params_from_jax(jax.tree.map(np.asarray, t), device="cpu")  # noqa: E731
    tcfg = t_pf.PFedSOPConfig(eta1=0.05, update_impl="reference")
    got, taux = t_pf.tree_personalize(to_t(jp), to_t(noise[0]), tree_map_f32(to_t(noise[1])),
                                      tcfg)
    np.testing.assert_allclose(float(taux["beta"]), float(jaux["beta"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert b.dtype == torch.bfloat16
        # one bf16 ulp: the f32 sums behind beta and the coefficient differ
        # in their last bits, which may move a rounding
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a.astype(jnp.float32)),
                                   rtol=2.0**-7, atol=1e-6)
    fused, faux = t_pf.tree_personalize(to_t(jp), to_t(noise[0]),
                                        tree_map_f32(to_t(noise[1])),
                                        t_pf.PFedSOPConfig(eta1=0.05))
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(fused))
    np.testing.assert_allclose(float(faux["beta"]), float(taux["beta"]), rtol=1e-5)


def tree_map_f32(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.float() for x in leaves])


def test_lm_cli_runs_on_the_cpu(capsys):
    driver.main(["--device", "cpu", "--arch", "granite-3-2b", "--rounds", "2",
                 "--clients", "2", "--local-iters", "1", "--batch", "2", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "round   1 loss=" in out and "OK: federated LM training" in out


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cfg = get_config("gemma3-1b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu' explicitly"):
        t_tf.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        driver.main(["--arch", "gemma3-1b", "--rounds", "1"])


def test_launch_count_formula_counts_the_bf16_dkv_sum_pass():
    """At full width gemma3-1b is bf16 with G = 4 query heads per KV head:
    every dk/dv pass is followed by its sum pass; the f32 smoke config
    launches none (its dk/dv pass writes dk/dv itself)."""
    full = driver.launches_per_step(get_config("gemma3-1b"))
    assert full["flash_bwd_dkv_sum"] == full["flash_bwd_dkv"] == 26
    assert "flash_bwd_dkv_sum" not in driver.launches_per_step(
        get_config("gemma3-1b", reduced=True))
    g1 = get_config("gemma3-1b").replace(n_kv_heads=get_config("gemma3-1b").n_heads)
    assert "flash_bwd_dkv_sum" not in driver.launches_per_step(g1)

