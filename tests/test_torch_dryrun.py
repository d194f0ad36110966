"""The port's launch tooling against ``repro``'s: ``steps.input_specs`` and
``make_train_step``, the dry run on the meta device, and the calibration.

- ``input_specs``: every leaf's (path, shape, dtype) equals ``repro``'s
  ``jax.eval_shape`` stand-ins for every arch x shape; the dry run's argument
  bytes are their byte sum.
- ``make_train_step`` at reduced width (f32) equals ``repro``'s
  ``make_train_step(engine=None)`` on numpy inputs from a seed with
  ``repro``'s init carried across: ``repro`` runs its plain references, the
  port "auto" (the plain versions of its kernels on the CPU).  Tolerances are
  tests/test_torch_lm.py's: loss rtol 1e-6, trees rtol 5e-4 / atol 1e-5.
- At full width on the meta device, the kernels' census per local step
  equals the launches the card counts (PERF.md §6; ``chip_smoke.py`` phases
  6, 13 and 15).
- ``MemoryCounter`` gives the peak of hand-built op chains.
- ``_unrolled_cfg`` equals ``repro``'s; the composed calibration equals a
  direct count of the full depth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import pfedsop as j_pf
from repro.launch import steps as j_steps
from repro.launch.calibrate import _unrolled_cfg as j_unrolled_cfg
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import pfedsop as t_pf
from repro_torch.kernels import meta
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.kernels.pfedsop_update import ops as update_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import calibrate, dryrun, roofline
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train_lm_pfedsop as driver
from repro_torch.utils.pytree import keystr, tree_flatten_with_path, tree_leaves
from repro_torch.weights import params_from_jax

SMALL = InputShape("small", seq_len=64, global_batch=1, kind="train")  # T = 1 at micro batch 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs files in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    """(path as jax.tree_util.keystr writes it, shape, dtype name) per leaf."""
    return [(keystr(p).replace("/", ""), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree_flatten_with_path(tree)]


def _j_leaves(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


# -- input specs ---------------------------------------------------------------


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_repro_leaf_for_leaf(arch, shape):
    got = t_steps.input_specs(get_config(arch), INPUT_SHAPES[shape], n_clients=1)
    want = j_steps.input_specs(j_get_config(arch), J_INPUT_SHAPES[shape], n_clients=1)
    assert all(x.is_meta for x in tree_leaves(got))
    assert _leaves(got) == _j_leaves(want)


@pytest.mark.parametrize("shape", ["decode_32k", SMALL], ids=["decode_32k", "train_small"])
def test_dryrun_argument_bytes_are_the_specs_byte_sum(shape):
    rec = dryrun.run_one("gemma3-1b", shape, save=False, verbose=False, micro_batch=1)
    j_shape = J_INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    want = j_steps.input_specs(j_get_config("gemma3-1b"), j_shape, micro_batch=1)
    nbytes = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                 for x in jax.tree.leaves(want))
    assert rec["memory_analysis"]["argument_size_in_bytes"] == nbytes
    assert rec["mesh"] == "1" and rec["n_devices"] == 1 and rec["collectives"] == {}
    assert rec["fits"] == (rec["peak_bytes"] <= roofline.HBM_CAPACITY)


# -- the train step against repro ---------------------------------------------


def _train_inputs(jcfg, clients, iters, batch, seq_len, seed):
    """repro's init and numpy deltas and batches from a seed, as jax and as
    port trees."""
    from repro.models import transformer as j_tf

    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, j_tf.init_params(jax.random.PRNGKey(seed), jcfg))
    stack = lambda make: jax.tree.map(  # noqa: E731
        lambda x: np.stack([make(x) for _ in range(clients)]), params)
    noise = lambda x: (0.01 * rng.standard_normal(x.shape)).astype(x.dtype)  # noqa: E731
    state = {"params": stack(lambda x: x + noise(x)), "delta": stack(noise)}
    global_delta = jax.tree.map(noise, params)
    toks = rng.randint(0, jcfg.vocab_size, (clients, iters, batch, seq_len)).astype(np.int32)
    batches = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}
    j_args = jax.tree.map(jnp.asarray, (state, global_delta, batches))
    t_args = params_from_jax((state, global_delta, batches), device="cpu")
    return j_args, t_args


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-1b-a400m"])
def test_make_train_step_equals_repro(arch):
    """Two clients, two local iterations, nonzero local and global deltas
    (the personalization runs): state, global delta and loss."""
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    shape = InputShape("small", seq_len=32, global_batch=4, kind="train")
    j_args, t_args = _train_inputs(jcfg, clients=2, iters=2, batch=2, seq_len=32, seed=3)
    j_pcfg = j_pf.PFedSOPConfig(eta1=0.1, eta2=0.1)
    t_pcfg = t_pf.PFedSOPConfig(eta1=0.1, eta2=0.1)
    j_state, j_global, j_loss = jax.jit(j_steps.make_train_step(jcfg, shape, j_pcfg))(*j_args)
    t_state, t_global, t_loss = t_steps.make_train_step(tcfg, shape, t_pcfg)(*t_args)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    for got, want in ((t_state, j_state), (t_global, j_global)):
        leaves = jax.tree.leaves(want)
        assert len(tree_leaves(got)) == len(leaves)
        for a, b in zip(tree_leaves(got), leaves):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=5e-4, atol=1e-5)


def test_make_train_step_refuses_an_engine():
    """An engine that is not a federation engine is refused (the step on a
    mesh engine is ``tests/test_torch_mesh_train.py``'s)."""
    with pytest.raises(TypeError, match="not a federation engine"):
        t_steps.make_train_step(get_config("gemma3-1b"), SMALL, engine=object())


def test_train_step_reads_nothing_back_on_meta():
    """The whole step on meta tensors at reduced width: no ``.item()``, no
    branch on a tensor's value (each raises on the meta device)."""
    cfg = get_config("gemma3-1b", reduced=True)
    specs = t_steps.input_specs(cfg, SMALL, n_clients=2, micro_batch=1)
    state, gd, loss = t_steps.make_train_step(cfg, SMALL)(
        specs["state"], specs["global_delta"], specs["batches"])
    assert loss.is_meta and loss.shape == ()
    assert _leaves(state) == _leaves(specs["state"])
    assert _leaves(gd) == _leaves(specs["global_delta"])


# -- the kernels' meta path ----------------------------------------------------


def test_meta_wrappers_allocate_and_record_without_launching():
    before = {**update_ops.LAUNCHES, **rms_ops.LAUNCHES, **flash_ops.LAUNCHES}
    b, s, h, kv, d = 2, 128, 4, 1, 64
    q = torch.empty((b, s, h, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, kv, d), dtype=torch.bfloat16, device="meta")
    x = torch.empty((3, 5000), device="meta")
    with meta.census() as c:
        out, lse = flash_ops.flash_fwd(q, k, k, window=32)
        delta = torch.empty((b, h, s), device="meta")
        dq = flash_ops.flash_bwd_dq(q, k, k, q, lse, delta, window=32)
        dk, dv = flash_ops.flash_bwd_dkv(q, k, k, q, lse, delta, window=32)
        y = rms_ops.rmsnorm_fwd(x, torch.empty(5000, device="meta"))
        new, beta = update_ops.pfedsop_update_batched(x, x, x[0])
    assert (out.shape, lse.shape, lse.dtype) == (q.shape, (b, h, s), torch.float32)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape and dk.dtype == torch.bfloat16
    assert y.shape == x.shape and new.shape == x.shape and beta.shape == (3,)
    assert c.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                          "flash_bwd_dkv_sum": 1, "rmsnorm": 1, "reduce3": 1, "update": 1}
    args = (b, s, h, kv, d, 32, 2)
    for name, cost in (("flash_fwd", roofline.flash_fwd_cost(*args)),
                       ("flash_bwd_dq", roofline.flash_dq_cost(*args)),
                       ("flash_bwd_dkv", roofline.flash_dkv_cost(*args)),
                       ("flash_bwd_dkv_sum", roofline.flash_dkv_sum_cost(b, s, h, kv, d)),
                       ("rmsnorm", roofline.rmsnorm_cost(3, 5000, 4)),
                       ("reduce3", roofline.reduce3_cost(3, 5000, 2, 4)),
                       ("update", roofline.update_cost(3, 5000, 4))):
        assert (c.flops[name], c.bytes[name]) == (cost["flops"], cost["bytes"]), name
    assert {**update_ops.LAUNCHES, **rms_ops.LAUNCHES, **flash_ops.LAUNCHES} == before


def test_reference_impl_on_meta_runs_the_oracle():
    q = torch.empty((1, 16, 2, 64), device="meta")
    with meta.census() as c:
        out = flash_ops.flash_gqa(q, q, q, impl="reference")
    assert out.shape == q.shape and c.launches == {}


def test_meta_path_checks_the_head_dim_as_the_card_does():
    q = torch.empty((1, 16, 2, 96), device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_fwd(q, q, q)


# -- the dry run at full width ---------------------------------------------------


@pytest.mark.parametrize("arch,want", [
    ("gemma3-1b", {"rmsnorm": 209, "flash_fwd": 52, "flash_bwd_dq": 26, "flash_bwd_dkv": 26,
                   "flash_bwd_dkv_sum": 26}),
    ("granite-moe-1b-a400m", {"rmsnorm": 97, "flash_fwd": 48, "flash_bwd_dq": 24,
                              "flash_bwd_dkv": 24, "flash_bwd_dkv_sum": 24}),
])
def test_launch_census_per_local_step_equals_the_card_counts(arch, want):
    rec = dryrun.run_one(arch, SMALL, micro_batch=1, save=False, verbose=False)
    assert rec["launches"] == {"reduce3": 1, "update": 1, **want}
    assert want == driver.launches_per_step(get_config(arch))
    assert rec["fits"] and rec["roofline"]["collective_s"] == 0.0


def test_moe_dispatch_variants_run_on_meta():
    for variant in ("moe_dispatch", "moe_grouped"):
        rec = dryrun.run_one("granite-moe-1b-a400m", SMALL, micro_batch=1, save=False,
                             verbose=False, variant=variant)
        assert rec["variant"] == variant and rec["launches"]["flash_fwd"] == 48


def test_mesh_layouts_and_seqshard_are_item_16():
    """The mesh layouts are item 16's done part (their counts are
    ``tests/test_torch_mesh_train.py``'s); ``seqshard``, its last part, is
    refused on every mesh, and ``both`` is the CLI's, not a layout."""
    for mesh in ("one", "single", "multi"):
        with pytest.raises(NotImplementedError, match="item 16"):
            dryrun.run_one("gemma3-1b", SMALL, save=False, verbose=False, mesh=mesh,
                           variant="seqshard")
    with pytest.raises(ValueError, match="single \\+ multi"):
        dryrun.run_one("gemma3-1b", SMALL, save=False, verbose=False, mesh="both")


def test_cli_writes_records_under_the_torch_artifact_dirs(tmp_path, monkeypatch):
    # never into repro's experiments/dryrun or experiments/roofline
    assert dryrun.ART_DIR.parts[-2:] == ("experiments", "dryrun_torch")
    assert calibrate.ART_DIR.parts[-2:] == ("experiments", "roofline_torch")
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path / "dryrun_torch")
    monkeypatch.setattr(calibrate, "ART_DIR", tmp_path / "roofline_torch")
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k"])
    calibrate.main(["--arch", "gemma3-1b", "--shape", "decode_32k"])
    rec = (tmp_path / "dryrun_torch" / "gemma3-1b__decode_32k__1.json")
    cal = (tmp_path / "roofline_torch" / "gemma3-1b__decode_32k__1.json")
    assert rec.exists() and cal.exists()


# -- the memory counter ----------------------------------------------------------


def test_memory_counter_peak_of_a_known_chain():
    a = torch.empty(1000, device="meta")  # 4,000 bytes, held

    def chain(x):
        b = x * 2  # +4,000
        c = b.exp()  # +4,000: the peak, 12,000
        del b  # -4,000
        d = c.view(10, 100).sum()  # a view moves nothing; +4
        return d

    with dryrun.MemoryCounter((a,)) as mem:
        out = chain(a)
    assert (mem.held, mem.peak, mem.live) == (4000, 12000, 4004)
    assert mem.storage_bytes(out) == 4
    # mul and exp read 4,000 and write 4,000; sum reads 4,000, writes 4
    assert mem.traffic == 8000 + 8000 + 4004


def test_memory_counter_adds_logsumexp_scratch():
    x = torch.empty(10, 100, device="meta")
    with dryrun.MemoryCounter((x,)) as mem:
        y = torch.logsumexp(x, -1)
    # the output (40 bytes) and ATen's x - max temporary (4,000) beside x
    assert mem.peak == 4000 + 40 + 4000 and y.shape == (10,)


def test_memory_counter_holds_gather_backward_in_place():
    x = torch.empty(1000, device="meta", requires_grad=True)
    idx = torch.zeros(10, dtype=torch.long, device="meta")
    with dryrun.MemoryCounter((x, idx)) as mem:
        (g,) = torch.autograd.grad(x.gather(0, idx).sum(), x)
    # x and idx, the loss and its seed gradient (4 bytes each), and the
    # zeros the gradient is scattered into (4,000), as eager's
    # ``scatter_add_`` holds them: not the out-of-place twin a dispatch mode
    # makes autograd allocate beside the zeros
    assert (mem.held, mem.peak) == (4080, 4080 + 4 + 4 + 4000) and g.shape == (1000,)


# -- the calibration ---------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,n,chunk", [
    ("gemma3-1b", "train_4k", 1, None), ("zamba2-2.7b", "prefill_32k", 1, None),
    ("zamba2-2.7b", "prefill_32k", 2, None), ("mamba2-2.7b", "train_4k", 1, 256)])
def test_unrolled_cfg_equals_repro(arch, shape, n, chunk):
    got = calibrate._unrolled_cfg(get_config(arch), INPUT_SHAPES[shape], n, ssm_chunk=chunk)
    want = j_unrolled_cfg(j_get_config(arch), J_INPUT_SHAPES[shape], n, ssm_chunk=chunk)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_composed_calibration_equals_a_direct_full_depth_count():
    """granite-moe (24 repetitions of a one-layer pattern, no tail) at T = 1:
    FLOPs and launches are linear in the depth, so the two-point composition
    is exact.  Bytes are not quite: the full config keeps each pattern
    position's layers stacked in one leaf, and the backward of its per-layer
    views (``unbind``) stacks their gradients, one more read and write of
    every stacked gradient, which the unrolled variants do not pay."""
    arch = "granite-moe-1b-a400m"
    cal = calibrate.calibrate_one(arch, SMALL, micro_batch=1, save=False, verbose=False)
    cfg = get_config(arch).replace(attn_q_block=SMALL.seq_len, ssm_chunk=SMALL.seq_len)
    direct = dryrun.run_one(arch, SMALL, micro_batch=1, save=False, verbose=False, cfg=cfg)
    assert cal["t_iters"] == 1
    assert cal["per_device"]["flops"] == direct["cost_analysis"]["flops"]
    assert cal["launches"] == direct["launches"]
    stacked = sum(x.numel() * x.element_size()
                  for x in tree_leaves(t_steps.abstract_params(cfg)["pattern"]))
    np.testing.assert_allclose(cal["per_device"]["bytes"] + 2 * stacked,
                               direct["cost_analysis"]["bytes accessed"], rtol=1e-6)
