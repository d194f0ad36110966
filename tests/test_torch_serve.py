"""Serving (KV-cache decode, prefill handoff, the int8 cache, the serve
steps and the serving driver) against ``repro`` at fp32, on the reduced
dense configs, with ``repro``'s parameters carried across by
``params_from_jax``.

The reduced configs keep their 512 / 4,096 windows, longer than any test
sequence, so the ring buffer would never wrap.  The ``wrap`` cases
therefore use ``cfg.replace(...)``, applied identically in both packages:
a pattern of (window 8, full attention) repeated twice plus a window-8
tail layer (n_rep > 1 and a tail, which the reduced configs lack), over
24 tokens.

Tolerances:

- ``init_caches``: the same tree and values, exactly.
- ``decode_step`` and ``prefill_with_caches`` logits and cache k/v against
  ``repro``: rtol 1e-5, atol 1e-5.  Both packages compute in f32 (the
  port's scores take f32 operands; ``repro`` accumulates in f32), and
  differ only in the order of the f32 sums (d_model 256 contractions, the
  softmax over the cache); measured <= 3e-6 on logits of size ~3.  The
  caches' ``pos`` slots are integers and equal exactly.
- decode after prefill against the port's own full forward: rtol = atol =
  5e-3, ``repro``'s own tolerance for this contract
  (``tests/test_models.py``), here with the kernels' plain versions
  ("auto" on the CPU) and the reference path.
- the int8 cache: ``_quantize``'s int8 values and bf16 scales bitwise
  against ``repro``'s on the same input; and ``repro``'s drift check (the
  quantized decode keeps the exact cache's argmax, logits within 0.15 of
  their largest magnitude).
- ``make_serve_step``'s greedy tokens equal ``repro``'s exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import DECODE_32K as J_DECODE
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro_torch.configs import DECODE_32K, LONG_500K, PREFILL_32K, get_config
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tf
from repro_torch.utils.pytree import tree_leaves, tree_map
from repro_torch.weights import params_from_jax

ARCHS = ["gemma3-1b", "gemma2-9b", "granite-3-2b"]


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


def _wrapping(cfg):
    """(window 8, full) x 2 + a window-8 tail layer, the arch's RoPE bases."""
    local = cfg.pattern[0].replace(window=8)
    glob = cfg.pattern[-1].replace(window=None)
    return cfg.replace(pattern=(local, glob), n_rep=2, tail=(local,), n_layers=5)


def _cfgs(arch, wrap, **kw):
    """(repro's config, the port's), the same in both packages."""
    j, t = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    if wrap:
        j, t = _wrapping(j), _wrapping(t)
    return j.replace(**kw), t.replace(**kw)


_PARAMS = {}


def _params(jcfg):
    """``repro``'s init for ``jcfg`` and the same tree in the port."""
    key = (jcfg.name, jcfg.n_layers)
    if key not in _PARAMS:
        jp = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[key] = (jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[key]


# repro's decode step, compiled once per config (eager, it dispatches op by op)
_j_decode = jax.jit(j_tf.decode_step, static_argnums=1)


def _tokens(cfg, b, s, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _caches_close(t_caches, j_caches):
    jl, tl = jax.tree.leaves(j_caches), tree_leaves(t_caches)
    assert jax.tree.structure(j_caches) == jax.tree.structure(
        tree_map(lambda x: 0, t_caches))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        if b.dtype == torch.int32:  # the pos slots
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_equal_repro_s(arch, wrap, kv_quant):
    jcfg, tcfg = _cfgs(arch, wrap, kv_quant=kv_quant)
    want = j_tf.init_caches(jcfg, 2, 20)
    got = t_tf.init_caches(tcfg, 2, 20, device="cpu")
    assert isinstance(got["pattern"], tuple) and len(got["pattern"]) == len(tcfg.pattern)
    assert jax.tree.structure(want) == jax.tree.structure(tree_map(lambda x: 0, got))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert tuple(b.shape) == a.shape and str(b.dtype)[6:] == a.dtype.name
        assert np.array_equal(b.float().numpy(), np.asarray(a, np.float32))
    if wrap:  # windowed layers hold 8 slots, full ones the whole budget
        assert got["pattern"][0]["k"].shape[:3] == (2, 2, 8)
        assert got["pattern"][1]["k"].shape[:3] == (2, 2, 20)
        assert got["tail"][0]["pos"].shape == (8,)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_repro(arch, wrap):
    """12 decode steps (24 with the wrapping layout, so the window-8 ring
    buffers wrap twice): logits each step, then the caches."""
    jcfg, tcfg = _cfgs(arch, wrap)
    jp, tp = _params(jcfg)
    s = 24 if wrap else 12
    toks = _tokens(tcfg, 2, s)
    jc = j_tf.init_caches(jcfg, 2, s)
    tc = t_tf.init_caches(tcfg, 2, s, device="cpu")
    for t in range(s):
        jl, jc = _j_decode(jp, jcfg, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                           jnp.asarray(t, jnp.int32), jc)
        tl, tc2 = t_tf.decode_step(tp, tcfg, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                   t, tc)
        assert tc2 is tc  # updated in place
        _close(tl, jl)
    _caches_close(tc, jc)
    if wrap:
        assert sorted(tc["tail"][0]["pos"].tolist()) == list(range(s - 8, s))


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_logits_match_repro(arch, wrap):
    jcfg, tcfg = _cfgs(arch, wrap)
    jp, tp = _params(jcfg)
    s = 24 if wrap else 12
    toks = _tokens(tcfg, 2, s)
    jl, jc = j_tf.prefill_with_caches(jp, jcfg, {"tokens": jnp.asarray(toks)}, capacity=s + 4)
    tl, tc = t_tf.prefill_with_caches(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                      capacity=s + 4)
    _close(tl, jl)
    _caches_close(tc, jc)


@pytest.mark.parametrize("impl", ["auto", "reference"])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_the_full_forward(arch, wrap, impl):
    """Prefill S tokens, then decode teacher-forced: each step's logits equal
    the full forward's at that position (the port's own forward).  With the
    wrapping layout the prompt (16) is longer than the window (8), so the
    prefill keeps the last 8 positions and decode wraps the ring buffer."""
    jcfg, tcfg = _cfgs(arch, wrap, kernel_impl=impl)
    _, tp = _params(jcfg)
    s, total = (16, 24) if wrap else (12, 14)
    toks = torch.from_numpy(_tokens(tcfg, 2, total, seed=3)).long()
    with torch.no_grad():
        hidden, _ = t_tf.forward(tp, tcfg, {"tokens": toks})
        full = t_tf.lm_logits(tp, tcfg, hidden)
    logits, caches = t_tf.prefill_with_caches(tp, tcfg, {"tokens": toks[:, :s]}, capacity=total)
    np.testing.assert_allclose(logits.numpy(), full[:, s - 1:s].numpy(), rtol=5e-3, atol=5e-3)
    for t in range(s, total):
        logits, caches = t_tf.decode_step(tp, tcfg, {"tokens": toks[:, t:t + 1]}, t, caches)
        np.testing.assert_allclose(logits.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=5e-3, atol=5e-3)


def test_prefill_launch_counts_are_one_projection_per_layer(monkeypatch):
    """Prefill projects q/k/v once per layer (``repro`` projects twice), so
    on the kernel path it runs 4 rmsnorms (ln1, q, k, ln2) and one flash
    forward per qk-norm layer, and the final norm once; counted here by
    the plain versions' calls, as the card counts launches."""
    _, tcfg = _cfgs("gemma3-1b", True)
    _, tp = _params(_cfgs("gemma3-1b", True)[0])
    calls = {"rms": 0, "flash": 0}
    rms, fwd = rms_ops.rmsnorm_fwd, flash_ops.flash_fwd
    monkeypatch.setattr(rms_ops, "rmsnorm_fwd",
                        lambda *a, **k: calls.__setitem__("rms", calls["rms"] + 1) or rms(*a, **k))
    monkeypatch.setattr(flash_ops, "flash_fwd",
                        lambda *a, **k: calls.__setitem__("flash", calls["flash"] + 1)
                        or fwd(*a, **k))
    toks = torch.from_numpy(_tokens(tcfg, 2, 16)).long()
    _, caches = t_tf.prefill_with_caches(tp, tcfg, {"tokens": toks}, capacity=20)
    assert calls == {"rms": 4 * tcfg.n_layers + 1, "flash": tcfg.n_layers}
    calls.update(rms=0, flash=0)
    t_tf.decode_step(tp, tcfg, {"tokens": toks[:, :1]}, 16, caches)
    assert calls == {"rms": 4 * tcfg.n_layers + 1, "flash": 0}


def test_decode_takes_a_tensor_position_bitwise():
    _, tcfg = _cfgs("gemma3-1b", True)
    _, tp = _params(_cfgs("gemma3-1b", True)[0])
    toks = torch.from_numpy(_tokens(tcfg, 2, 12)).long()
    a = t_tf.init_caches(tcfg, 2, 12, device="cpu")
    b = t_tf.init_caches(tcfg, 2, 12, device="cpu")
    for t in range(12):
        la, a = t_tf.decode_step(tp, tcfg, {"tokens": toks[:, t:t + 1]}, t, a)
        lb, b = t_tf.decode_step(tp, tcfg, {"tokens": toks[:, t:t + 1]},
                                 torch.tensor(t, dtype=torch.int32), b)
        assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_quantize_is_bitwise_repro_s():
    x = (np.random.RandomState(0).randn(4, 2, 8, 64) * 5.0).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    x[1, 0, 0, :4] = [127.0, 0.5, -0.5, 1.5]  # ties at .5 round to even
    jq, js = j_attn._quantize(jnp.asarray(x))
    tq, ts = t_attn._quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))


@pytest.mark.parametrize("wrap", [False, True])
def test_int8_cache_decode_tracks_the_exact_cache(wrap):
    """``repro``'s check on granite-3-2b: the int8 cache keeps the argmax,
    and the logits within 0.15 of their largest magnitude; and a prefilled
    int8 cache equals ``repro``'s bitwise in its int8 values and scales
    where the projections agree."""
    jcfg, tcfg = _cfgs("granite-3-2b", wrap)
    _, tp = _params(jcfg)
    s = 24 if wrap else 10
    toks = torch.from_numpy(_tokens(tcfg, 1, s)).long()
    outs = {}
    for quant in (False, True):
        c = tcfg.replace(kv_quant=quant)
        caches = t_tf.init_caches(c, 1, s, device="cpu")
        for t in range(s):
            logits, caches = t_tf.decode_step(tp, c, {"tokens": toks[:, t:t + 1]}, t, caches)
        outs[quant] = logits.numpy()
        if quant:
            assert caches["pattern"][0]["k"].dtype == torch.int8
    assert np.argmax(outs[False]) == np.argmax(outs[True])
    drift = np.max(np.abs(outs[True] - outs[False]))
    assert drift < 0.15 * np.max(np.abs(outs[False])), drift


def test_int8_prefill_cache_matches_repro():
    jcfg, tcfg = _cfgs("granite-3-2b", True, kv_quant=True)
    jp, tp = _params(_cfgs("granite-3-2b", True)[0])
    toks = _tokens(tcfg, 2, 12)
    _, jc = j_tf.prefill_with_caches(jp, jcfg, {"tokens": jnp.asarray(toks)}, capacity=16)
    _, tc = t_tf.prefill_with_caches(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                     capacity=16)
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        a = np.asarray(a)
        if b.dtype == torch.int8:  # a value next to a rounding edge may move by one
            d = np.abs(b.numpy().astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1 and np.mean(d == 0) > 0.99
        elif b.dtype == torch.bfloat16:
            np.testing.assert_allclose(b.float().numpy(), a.astype(np.float32), rtol=2.0 ** -7)
        else:
            np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_prefill_steps_match_repro(arch):
    """``make_serve_step``'s greedy tokens equal ``repro``'s (whose step
    carries a leading pod axis of 1), 8 steps fed back; ``make_prefill_step``'s
    logits within 1e-5."""
    jcfg, tcfg = _cfgs(arch, False)
    jp, tp = _params(jcfg)
    j_serve = jax.jit(j_steps.make_serve_step(jcfg, J_DECODE))
    t_serve = t_steps.make_serve_step(tcfg, DECODE_32K)
    jc = jax.tree.map(lambda x: x[None], j_tf.init_caches(jcfg, 2, 16))
    tc = t_tf.init_caches(tcfg, 2, 16, device="cpu")
    toks = _tokens(tcfg, 2, 1)
    jt, tt = jnp.asarray(toks)[None], torch.from_numpy(toks).long()
    p1 = jax.tree.map(lambda x: x[None], jp)
    for t in range(8):
        jt, jc = j_serve(p1, {"tokens": jt}, jnp.asarray(t, jnp.int32), jc)
        tt, tc = t_serve(tp, {"tokens": tt.long()}, t, tc)
        assert tt.dtype == torch.int32
        assert np.array_equal(tt.numpy(), np.asarray(jt)[0]), t
    batch = _tokens(tcfg, 2, 12)
    want = j_steps.make_prefill_step(jcfg, J_DECODE)(
        p1, {"tokens": jnp.asarray(batch)[None]})[0]
    _close(t_steps.make_prefill_step(tcfg, PREFILL_32K)(tp, {"tokens": torch.from_numpy(batch)}),
           want)


def test_long_context_shape_names_its_roadmap_item():
    """``long_500k`` serves through ``apply_long_context`` (ROADMAP.md queue
    1, item 14): every window capped at 4,096, and the decode step runs."""
    cfg = get_config("gemma3-1b", reduced=True)
    assert t_steps.resolve_cfg(cfg, DECODE_32K) is cfg
    long = t_steps.resolve_cfg(cfg, LONG_500K)
    assert long == t_tf.apply_long_context(cfg)
    assert [s.window for s in long.layers] == [512, 4096]
    caches = t_tf.init_caches(long, 1, 8, device="cpu")
    tp = t_tf.init_params(torch.Generator().manual_seed(0), long, device="cpu")
    tok, _ = t_steps.make_serve_step(cfg, LONG_500K)(
        tp, {"tokens": torch.zeros((1, 1), dtype=torch.int64)}, 0, caches)
    assert tok.shape == (1, 1)


@pytest.mark.parametrize("extra", [[], ["--prompt-len", "6"]])
def test_serve_driver_runs_on_the_cpu(extra, capsys):
    gen = serve.main(["--device", "cpu", "--steps", "4", "--batch", "2", "--capacity", "16"]
                     + extra)
    assert gen.shape == (2, 4)
    out = capsys.readouterr().out
    assert "tokens/s" in out and out.rstrip().endswith("OK")
    assert ("prompt: 6 tokens" in out) == bool(extra)


@pytest.mark.parametrize("argv, message", [
    (["--kernel-impl", "kernel_interpret"], "no counterpart"),
    (["--prompt-len", "60", "--steps", "8"], "exceeds --capacity")])
def test_serve_driver_refusals(argv, message, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"] + argv)
    assert message in capsys.readouterr().err
