"""The MoE, SSM, hybrid and modality-frontend archs (olmoe-1b-7b,
granite-moe-1b-a400m, mamba2-2.7b, zamba2-2.7b, internvl2-2b,
musicgen-large) and ``apply_long_context`` against ``repro``, with
``repro``'s parameters carried across by ``params_from_jax``.  ``repro``
runs as its own tests run it: "reference", or its Pallas kernels in
interpret mode; the port runs "reference" or "auto" (on the CPU, the
plain versions of its CUDA kernels).

Tolerances:

- whole-stack loss rtol 1e-6 and grads rtol 5e-4 / atol 1e-5, and the
  3-round federated history rtol 1e-4: ``tests/test_torch_lm.py``'s
  (f32 sums in another order; the MoE router's top-k picks the same
  experts, the logits being far from ties).
- ``ssd_chunked`` at bf16: within 2**-10 of the largest |y|.  Both
  packages round to bf16 at the same places (``repro``'s ``.astype``
  casts of w, x*dt, the decay weights and the carried state) and
  accumulate in f32; f32 sums in another order move a few of those
  roundings by one bf16 ulp, which reads ~2e-4 of the largest value.
  One extra bf16 rounding of y (an einsum that returned bf16) would cost
  up to 2**-9, and skipping ``repro``'s roundings ~3e-3: both fail.
  ``ssm_forward`` at bf16 (a bf16 output): one bf16 ulp, 2**-7 of the
  largest value.
- serving, ``tests/test_torch_serve.py``'s: decode and prefill logits and
  caches rtol = atol = 1e-5 against ``repro`` (the SSM state and conv
  window included); 5e-3 against the port's own full forward; int8 cache
  values within one step of ``repro``'s and ``_quantize`` bitwise on the
  same input.  musicgen-large's int8 KV cache is held as
  ``tests/test_torch_serve.py`` holds it: decode reads dequantized k/v, so
  a value that f32 noise moves across a rounding edge moves one int8 step
  (measured 1.1e-3 on logits of ~2 against ``repro``), so its decode is
  held to 1e-5 / 5e-3 with the exact cache (``kv_quant=False``), and the
  int8 decode to ``repro``'s drift check against the exact cache.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _jax_loop

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import get_config as j_get_config
from repro.configs.base import DECODE_32K as J_DECODE
from repro.configs.base import LONG_500K as J_LONG_500K
from repro.core import pfedsop as j_pf
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro_torch.configs import ARCH_NAMES, DECODE_32K, LONG_500K, get_config
from repro_torch.core import pfedsop as t_pf
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import serve
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train_lm_pfedsop as driver
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.utils.pytree import FlatLayout, tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.weights import params_from_jax, params_to_numpy

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m", "mamba2-2.7b", "zamba2-2.7b",
         "internvl2-2b", "musicgen-large"]
MODULES = ["olmoe_1b_7b", "granite_moe_1b_a400m", "mamba2_2_7b", "zamba2_2_7b",
           "internvl2_2b", "musicgen_large"]
TEXT_ARCHS = ARCHS[:4]


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


_PARAMS = {}


def _params(jcfg):
    """``repro``'s init for ``jcfg`` and the same tree in the port."""
    key = (jcfg.name, jcfg.dtype)
    if key not in _PARAMS:
        jp = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[key] = (jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[key]


def _cfgs(arch, **kw):
    return (j_get_config(arch, reduced=True).replace(**kw),
            get_config(arch, reduced=True).replace(**kw))


def _batch(cfg, b, s, seed, labels=True):
    """Numpy inputs in ``steps.token_batch``'s layout over ``s`` positions
    (for the vision arch, ``n_patches`` of them patches)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, (shape, dtype) in t_steps.token_batch(cfg, b, s).items():
        if name == "labels" and not labels:
            continue
        out[name] = (rng.randn(*shape).astype(np.float32) if dtype.is_floating_point
                     else rng.randint(0, cfg.vocab_size, shape).astype(np.int32))
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("mod", MODULES)
def test_arch_config_copies_differ_only_in_the_import_line(mod):
    a = (SRC / "repro/configs" / f"{mod}.py").read_text()
    b = (SRC / "repro_torch/configs" / f"{mod}.py").read_text()
    assert b == a.replace("from repro.configs.base import", "from repro_torch.configs.base import")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro(arch, reduced):
    assert (dataclasses.asdict(get_config(arch, reduced=reduced))
            == dataclasses.asdict(j_get_config(arch, reduced=reduced)))


def test_every_arch_is_served():
    assert ARCH_NAMES == J_ARCH_NAMES and len(ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_long_context_config_equals_repro(arch):
    """``resolve_cfg(cfg, long_500k)``: windows capped at 4,096 on the
    window-mode archs, the native (SSM, hybrid) ones unchanged."""
    got = t_steps.resolve_cfg(get_config(arch), LONG_500K)
    want = j_steps.resolve_cfg(j_get_config(arch), J_LONG_500K)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert t_steps.resolve_cfg(get_config(arch), DECODE_32K) == get_config(arch)
    if got.long_context_mode == "window":
        assert all(s.window is not None and s.window <= got.long_context_window
                   for s in got.layers if s.kind != "ssm")


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_batch_layouts_equal_repro(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for got, want in ((t_steps.token_batch(cfg, 3, 300), j_steps._token_batch(jcfg, 3, 300)),
                      (t_steps.decode_batch(cfg, 3), j_steps._decode_batch(jcfg, 3))):
        assert sorted(got) == sorted(want)
        for k, (shape, dtype) in got.items():
            assert shape == want[k].shape and str(dtype)[6:] == want[k].dtype.name


# -- weights -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tree_round_trips_in_jax_leaf_order(arch):
    """Expert stacks, the SSM's f32 leaves beside bf16 ones, the hybrid's
    empty ``shared_attn`` positions and its shared block, ``vis_proj`` and
    the codebook heads: leaf for leaf in ``jax.tree.leaves`` order, bit for
    bit, and ``FlatLayout``'s paths are ``repro``'s."""
    cfg = j_get_config(arch, reduced=True).replace(dtype="bfloat16")
    jp = j_tf.init_params(jax.random.PRNGKey(3), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jl = jax.tree.leaves(jp)
    assert len(tree_leaves(tp)) == len(jl)
    for a, b in zip(jl, tree_leaves(tp)):
        assert str(b.dtype)[6:] == a.dtype.name and tuple(b.shape) == a.shape
        assert np.array_equal(b.view(torch.int16 if b.dtype == torch.bfloat16 else b.dtype)
                              .numpy(), np.asarray(a).view(np.int16) if
                              a.dtype == jnp.bfloat16 else np.asarray(a))
    assert FlatLayout(tp).paths == ["/".join(str(k) for k in path) for path, _ in
                                    jax.tree_util.tree_flatten_with_path(jp)[0]]
    back = jax.tree.unflatten(jax.tree.structure(jp), tree_leaves(params_to_numpy(tp)))
    for a, b in zip(jl, jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a).astype(np.float32), b)
    if cfg.family == "hybrid":
        assert "shared" in tp and tp["pattern"][-1] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_builds_repro_s_tree(arch):
    """The port's random init: ``repro``'s structure, shapes and dtypes."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    want = jax.eval_shape(lambda k: j_tf.init_params(k, jcfg), jax.random.PRNGKey(0))
    got = t_tf.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(tree_map(lambda x: 0, got))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert tuple(b.shape) == a.shape and str(b.dtype)[6:] == a.dtype.name


# -- MoE ---------------------------------------------------------------------


def test_top_k_follows_lax_top_k_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = t_moe._top_k(torch.from_numpy(x), 4)
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("impl,factor", [("dense", 1.25), ("dispatch", 1.25),
                                         ("dispatch", 0.5), ("dispatch_grouped", 1.25),
                                         ("dispatch_grouped", 0.5)])
def test_moe_ffn_output_aux_and_grads_match_repro(impl, factor):
    """Each of the three impls (at capacity factor 0.5 the dispatch buffers
    overflow and drop slots) on granite-moe's reduced block: output, aux
    loss and the gradients of their sum."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", capacity_factor=factor)
    rng = np.random.RandomState(2)
    jp = j_moe.moe_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = rng.randn(2, 24, jcfg.d_model).astype(np.float32)
    w = rng.randn(2, 24, jcfg.d_model).astype(np.float32)

    def j_obj(p, xx):
        y, aux = j_moe.moe_ffn(p, jcfg, xx, impl)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    leaves, treedef = tree_flatten(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    leaves = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = t_moe.moe_ffn(tree_unflatten(treedef, leaves), tcfg, tx, impl)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum() + taux, leaves + [tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    for a, b in zip(grads, jax.tree.leaves(jg[0]) + [jg[1]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=1e-5)


def test_moe_aux_loss_flows_through_forward_and_lm_loss():
    jcfg, tcfg = _cfgs("olmoe-1b-7b", kernel_impl="reference")
    jp, tp = _params(jcfg)
    batch = _batch(tcfg, 2, 32, seed=4)
    _, j_aux = j_tf.forward(jp, jcfg, _jax(batch))
    _, t_aux = t_tf.forward(tp, tcfg, _torch(batch))
    assert float(t_aux) > 0
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-6)
    with torch.no_grad():
        hidden, _ = t_tf.forward(tp, tcfg, _torch(batch))
        ce = t_tf.cross_entropy(t_tf.lm_logits(tp, tcfg, hidden), _torch(batch)["labels"])
        loss = t_tf.lm_loss(tp, tcfg, _torch(batch))
    np.testing.assert_allclose(float(loss), float(ce + t_tf.AUX_LOSS_COEF * t_aux), rtol=1e-7)


# -- SSM at bf16 -------------------------------------------------------------


def _ssd_inputs(seed):
    rng = np.random.RandomState(seed)
    b, s, h, p, n = 2, 64, 8, 64, 16
    return (rng.randn(b, s, h, p), rng.randn(b, s, n), rng.randn(b, s, n),
            np.log1p(np.exp(rng.randn(b, s, h) - 2.0)), -np.exp(0.5 * rng.randn(h)))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunked_bf16_matches_repro(seed):
    """bf16 operands, f32 dt and A: y and the final state (both f32)."""
    cfg = j_get_config("mamba2-2.7b", reduced=True).replace(dtype="bfloat16")
    xh, bm, cm, dt, a = (x.astype(np.float32) for x in _ssd_inputs(seed))
    jy, jh = j_ssm.ssd_chunked(cfg, *(jnp.asarray(x).astype(jnp.bfloat16) for x in (xh, bm, cm)),
                               jnp.asarray(dt), jnp.asarray(a))
    ty, th = t_ssm.ssd_chunked(get_config("mamba2-2.7b", reduced=True).replace(
        dtype="bfloat16"), *(torch.from_numpy(x).to(torch.bfloat16) for x in (xh, bm, cm)),
        torch.from_numpy(dt), torch.from_numpy(a))
    assert ty.dtype == th.dtype == torch.float32
    jy, jh = np.asarray(jy), np.asarray(jh)
    assert np.abs(ty.numpy() - jy).max() <= 2.0**-10 * np.abs(jy).max()
    assert np.abs(th.numpy() - jh).max() <= 2.0**-10 * np.abs(jh).max()


def test_ssm_forward_bf16_matches_repro():
    jcfg, tcfg = _cfgs("mamba2-2.7b", dtype="bfloat16")
    jp = j_ssm.ssm_init(jax.random.PRNGKey(5), jcfg, jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.RandomState(6).randn(2, 64, jcfg.d_model).astype(np.float32)
    jy = np.asarray(j_ssm.ssm_forward(jp, jcfg, jnp.asarray(x).astype(jnp.bfloat16))
                    .astype(jnp.float32))
    ty = t_ssm.ssm_forward(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    assert np.abs(ty.float().numpy() - jy).max() <= 2.0**-7 * np.abs(jy).max()


# -- whole stack -------------------------------------------------------------


@pytest.mark.parametrize("impls", [("reference", "reference"), ("kernel_interpret", "auto")],
                         ids=["reference", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_stack_loss_and_grads_match_repro(arch, impls):
    jc, tc = _cfgs(arch)
    jc, tc = jc.replace(kernel_impl=impls[0]), tc.replace(kernel_impl=impls[1])
    batch = _batch(jc, 2, 64, seed=1)
    jp, _ = _params(jc)
    j_loss, j_grads = jax.value_and_grad(lambda p: j_tf.lm_loss(p, jc, _jax(batch)))(jp)
    leaves, treedef = tree_flatten(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    t_loss = t_tf.lm_loss(tree_unflatten(treedef, leaves), tc, _torch(batch))
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-6, atol=1e-7)
    for a, b in zip(t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b", "mamba2-2.7b"])
def test_launch_count_formula(arch, monkeypatch):
    """``launches_per_step`` per sublayer kind (an ``ssm`` sublayer: one
    K4, again under remat, no flash kernel), counted as the plain
    versions' calls."""
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
    cfg = get_config(arch, reduced=True)
    params = t_tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves, treedef = tree_flatten(params)
    leaves = [x.requires_grad_() for x in leaves]
    torch.autograd.grad(t_tf.lm_loss(tree_unflatten(treedef, leaves), cfg,
                                     _torch(_batch(cfg, 2, 16, 0))), leaves)
    want = driver.launches_per_step(cfg)
    assert calls == {k: want.get(k, 0) for k in calls}
    full = driver.launches_per_step(get_config(arch))
    n_attn = {"granite-moe-1b-a400m": 24, "zamba2-2.7b": 9, "mamba2-2.7b": 0}[arch]
    assert full["rmsnorm"] == 2 * (2 * n_attn + get_config(arch).n_layers - n_attn) + 1
    assert full.get("flash_bwd_dkv_sum", 0) == (n_attn if arch.startswith("granite") else 0)


# -- the slice ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_federated_lm_history_matches_repro(arch):
    """2 clients, 2 local iterations, 3 rounds of the port's driver against
    the example's loop in ``repro`` (reference update and model)."""
    kw = dict(clients=2, rounds=3, local_iters=2, batch=2, seq_len=32)
    jc = j_get_config(arch, reduced=True).replace(kernel_impl="reference")
    jp = j_tf.init_params(jax.random.PRNGKey(0), jc)
    j_hist, j_states = _jax_loop(
        jc, jp, j_pf.PFedSOPConfig(eta1=0.1, eta2=0.1, update_impl="reference"), **kw)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    t_hist, t_states = driver.train(get_config(arch, reduced=True), tp,
                                    t_pf.PFedSOPConfig(eta1=0.1, eta2=0.1), **kw)
    assert j_hist["personalized"] == [[False, False], [True, True], [True, True]]
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-4)
    np.testing.assert_allclose(t_hist["beta"], j_hist["beta"], rtol=1e-4)
    for j_state, t_state in zip(j_states, t_states):
        for a, b in zip(jax.tree.leaves(j_state.params), tree_leaves(t_state.params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("arch", TEXT_ARCHS)
def test_lm_cli_runs_on_the_cpu(arch, capsys):
    driver.main(["--device", "cpu", "--arch", arch, "--rounds", "2", "--clients", "2",
                 "--local-iters", "1", "--batch", "2", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "round   1 loss=" in out and "OK: federated LM training" in out


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large"])
def test_lm_cli_refuses_the_frontend_archs(arch):
    with pytest.raises(SystemExit, match="needs a modality frontend"):
        driver.main(["--device", "cpu", "--arch", arch, "--rounds", "1"])


# -- serving -----------------------------------------------------------------

# repro's decode step, compiled once per config (eager, it dispatches op by op)
_j_decode = jax.jit(j_tf.decode_step, static_argnums=1)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _caches_close(t_caches, j_caches):
    assert jax.tree.structure(j_caches) == jax.tree.structure(tree_map(lambda x: 0, t_caches))
    for a, b in zip(jax.tree.leaves(j_caches), tree_leaves(t_caches)):
        assert tuple(b.shape) == a.shape and str(b.dtype)[6:] == a.dtype.name
        if b.dtype in (torch.int32, torch.int8):  # pos slots; int8 values
            d = np.abs(b.numpy().astype(np.int32) - np.asarray(a).astype(np.int32))
            assert d.max() <= (1 if b.dtype == torch.int8 else 0)
        elif b.dtype == torch.bfloat16:  # int8 scales
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                       rtol=2.0**-7)
        else:
            _close(b, a)


def _decode_inputs(cfg, toks, t):
    """Step t's decode batch from prompt-layout tokens (B, S) / (B, K, S)."""
    out = {"tokens": toks[..., t:t + 1]}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = np.zeros((toks.shape[0], 0, cfg.d_vision), np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_equal_repro_s(arch):
    jcfg, tcfg = _cfgs(arch)
    want = j_tf.init_caches(jcfg, 2, 20)
    got = t_tf.init_caches(tcfg, 2, 20, device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(tree_map(lambda x: 0, got))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert tuple(b.shape) == a.shape and str(b.dtype)[6:] == a.dtype.name
        assert np.array_equal(b.float().numpy(), np.asarray(a, np.float32))


def _exact(arch):
    """Config edits for the 1e-5 / 5e-3 decode comparisons: the exact cache
    for musicgen-large (its int8 cache: ``test_int8_codebook_...``)."""
    return {"kv_quant": False} if arch == "musicgen-large" else {}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_repro(arch):
    """10 decode steps from empty caches: logits each step, then the caches
    (the SSM's conv window and state, written in place)."""
    jcfg, tcfg = _cfgs(arch, **_exact(arch))
    jp, tp = _params(jcfg)
    s = 10
    toks = _batch(tcfg, 2, s + tcfg.n_patches, seed=1, labels=False)["tokens"]
    jc = j_tf.init_caches(jcfg, 2, s)
    tc = t_tf.init_caches(tcfg, 2, s, device="cpu")
    held = tree_leaves(tc)
    for t in range(s):
        batch = _decode_inputs(tcfg, toks, t)
        jl, jc = _j_decode(jp, jcfg, _jax(batch), jnp.asarray(t, jnp.int32), jc)
        tl, tc2 = t_tf.decode_step(tp, tcfg, _torch(batch), t, tc)
        assert tc2 is tc and all(a is b for a, b in zip(tree_leaves(tc), held))
        _close(tl, jl)
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_logits_match_repro(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(tcfg, 2, 12 + jcfg.n_patches, seed=2, labels=False)
    jl, jc = j_tf.prefill_with_caches(jp, jcfg, _jax(batch), capacity=24)
    tl, tc = t_tf.prefill_with_caches(tp, tcfg, _torch(batch), capacity=24)
    _close(tl, jl)
    _caches_close(tc, jc)


@pytest.mark.parametrize("impl", ["auto", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_the_full_forward(arch, impl):
    """Prefill, then decode teacher-forced: each step's logits equal the
    port's full forward at that position."""
    _, tcfg = _cfgs(arch, kernel_impl=impl, **_exact(arch))
    _, tp = _params(_cfgs(arch)[0])
    npat = tcfg.n_patches
    s, total = 10, 14
    full_in = _torch(_batch(tcfg, 2, total + npat, seed=3, labels=False))
    with torch.no_grad():
        hidden, _ = t_tf.forward(tp, tcfg, full_in)
        full = t_tf.lm_logits(tp, tcfg, hidden[:, npat:])
    prompt = dict(full_in, tokens=full_in["tokens"][..., :s])
    logits, caches = t_tf.prefill_with_caches(tp, tcfg, prompt, capacity=total + npat)
    np.testing.assert_allclose(logits.numpy(), full[:, s - 1:s].numpy(), rtol=5e-3, atol=5e-3)
    toks = full_in["tokens"].numpy()
    for t in range(s, total):
        logits, caches = t_tf.decode_step(tp, tcfg, _torch(_decode_inputs(tcfg, toks, t)),
                                          t + npat, caches)
        np.testing.assert_allclose(logits.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=5e-3, atol=5e-3)


def test_int8_codebook_cache_quantizes_bitwise():
    """musicgen-large's int8 KV cache: ``_quantize`` on the port's prefill
    k/v equals ``repro``'s bitwise, and the prefilled cache holds them."""
    _, tcfg = _cfgs("musicgen-large")
    _, tp = _params(_cfgs("musicgen-large")[0])
    assert tcfg.kv_quant
    batch = _torch(_batch(tcfg, 2, 12, seed=5, labels=False))
    x, positions = t_tf.embed_inputs(tp, tcfg, batch)
    block = tree_map(lambda a: a[0], tp["pattern"][0])
    h = t_tf._norm(block["ln1"], tcfg, x)
    with torch.no_grad():
        _, k, v = t_attn._project_qkv(block["attn"], tcfg, h, positions, 10_000.0)
    for t in (k, v):
        tq, ts = t_attn._quantize(t)
        jq, js = j_attn._quantize(jnp.asarray(t.numpy()))
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    _, caches = t_tf.prefill_with_caches(tp, tcfg, batch, capacity=16)
    assert torch.equal(caches["pattern"][0]["k"][0, :, :12], t_attn._quantize(k)[0])


def test_int8_codebook_decode_tracks_the_exact_cache():
    """``repro``'s drift check on musicgen-large: 12 decode steps on the int8
    cache keep the exact cache's argmax in every codebook, logits within
    0.15 of their largest magnitude."""
    _, tcfg = _cfgs("musicgen-large")
    _, tp = _params(_cfgs("musicgen-large")[0])
    toks = _batch(tcfg, 1, 12, seed=6, labels=False)["tokens"]
    outs = {}
    for quant in (False, True):
        c = tcfg.replace(kv_quant=quant)
        caches = t_tf.init_caches(c, 1, 12, device="cpu")
        for t in range(12):
            logits, caches = t_tf.decode_step(tp, c, _torch(_decode_inputs(c, toks, t)), t,
                                              caches)
        outs[quant] = logits.numpy()
        assert caches["pattern"][0]["k"].dtype == (torch.int8 if quant else torch.float32)
    assert np.array_equal(outs[False].argmax(-1), outs[True].argmax(-1))
    drift = np.max(np.abs(outs[True] - outs[False]))
    assert drift < 0.15 * np.max(np.abs(outs[False])), drift


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "internvl2-2b", "musicgen-large"])
def test_serve_steps_match_repro(arch):
    """``make_serve_step``'s greedy tokens equal ``repro``'s (whose step
    carries a leading pod axis of 1), 6 steps fed back."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    j_serve = jax.jit(j_steps.make_serve_step(jcfg, J_DECODE))
    t_serve = t_steps.make_serve_step(tcfg, DECODE_32K)
    jc = jax.tree.map(lambda x: x[None], j_tf.init_caches(jcfg, 2, 8))
    tc = t_tf.init_caches(tcfg, 2, 8, device="cpu")
    batch = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt)
             in t_steps.decode_batch(tcfg, 2).items()}
    p1 = jax.tree.map(lambda x: x[None], jp)
    for t in range(6):
        jt, jc = j_serve(p1, jax.tree.map(lambda x: jnp.asarray(x.numpy())[None], batch),
                         jnp.asarray(t, jnp.int32), jc)
        tt, tc = t_serve(tp, batch, t, tc)
        assert tt.dtype == torch.int32 and np.array_equal(tt.numpy(), np.asarray(jt)[0]), t
        batch["tokens"] = t_steps.next_tokens(tcfg, tt)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_on_the_cpu(arch, capsys):
    gen = serve.main(["--device", "cpu", "--arch", arch, "--steps", "3", "--batch", "2",
                      "--capacity", "16", "--prompt-len", "4"])
    k = get_config(arch).n_codebooks
    assert gen.shape == ((2, 3, k) if k else (2, 3))
    out = capsys.readouterr().out
    assert "prompt: 4 tokens" in out and out.rstrip().endswith("OK")
