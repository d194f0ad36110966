"""The port's scripts and quickstart (``scripts/torch_*.py``,
``examples/torch_quickstart.py``), each run in this process with ``--device
cpu`` at its reduced size: the assertions each script makes (finite losses,
the quickstart's convergence) hold, and the roofline table reads the dry
run's and the calibration's records.  Each imports nothing of JAX or
``repro`` and asks for the card unless told otherwise.
"""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import calibrate, dryrun, roofline
from repro_torch.launch import train_lm_pfedsop as lm_driver
from repro_torch.models import transformer as tf

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ["scripts/torch_smoke_models.py", "scripts/torch_smoke_fl.py",
           "scripts/torch_roofline_table.py", "examples/torch_quickstart.py"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs files in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rel", SCRIPTS)
def test_script_imports_only_the_port(rel):
    src = (ROOT / rel).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)",
                         src, re.M)
    original = (ROOT / rel.replace("torch_", "")).read_text()
    assert original != src  # the original stays beside it


@pytest.mark.parametrize("rel", ["scripts/torch_phases.py", "scripts/torch_flash_ab.py"])
def test_card_script_imports_only_the_port(rel):
    """The card's own scripts (no ``repro`` original) import neither JAX
    nor ``repro``."""
    src = (ROOT / rel).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)",
                         src, re.M)
    assert "import chip_smoke as cs" in src


@pytest.mark.parametrize("rel", ["scripts/torch_smoke_models.py", "scripts/torch_smoke_fl.py",
                                 "examples/torch_quickstart.py"])
def test_script_asks_for_the_card_by_default(rel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _load(rel).main([])


def test_quickstart_converges_on_the_cpu(capsys):
    states = _load("examples/torch_quickstart.py").main(["--device", "cpu"])
    for st, target in zip(states, (2.0, -1.0)):
        assert float((st.params["w"] - target).abs().max()) < 0.2
    assert "OK: each client converged" in capsys.readouterr().out


def test_smoke_models_runs_every_reduced_arch(capsys):
    _load("scripts/torch_smoke_models.py").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(" OK") == 10


def test_smoke_fl_runs_pfedsop_and_fedavg():
    hists = _load("scripts/torch_smoke_fl.py").main(["--device", "cpu", "--rounds", "2"])
    assert set(hists) == {"pfedsop", "fedavg"}
    for h in hists.values():
        assert len(h["loss"]) == 2 and np.isfinite(h["loss"]).all()


def test_roofline_table_reads_the_torch_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path / "dryrun_torch")
    monkeypatch.setattr(calibrate, "ART_DIR", tmp_path / "roofline_torch")
    rec = dryrun.run_one("gemma3-1b", "decode_32k", verbose=False)
    calibrate.calibrate_one("gemma3-1b", "decode_32k", verbose=False)
    table = _load("scripts/torch_roofline_table.py")
    (row,) = table.main(["--art-dir", str(tmp_path / "dryrun_torch")])
    mf = roofline.model_flops(get_config("gemma3-1b"), INPUT_SHAPES["decode_32k"])
    assert row["model_flops"] == mf and row["counted_flops"] == rec["roofline"]["total_flops"]
    mem = rec["memory_analysis"]
    assert row["hbm_gb"] == (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9
    assert row["dominant"] == rec["roofline"]["dominant"]
    (cal,) = table.main(["--calibrated", "--art-dir", str(tmp_path / "roofline_torch")])
    assert cal["model_flops"] == mf and np.isnan(cal["hbm_gb"])
    assert "| gemma3-1b | decode_32k |" in capsys.readouterr().out


@pytest.fixture(scope="module")
def _phase15_grads():
    """``chip_smoke.py``'s phase-15 gradient check on the reduced gemma3-1b
    in bf16, B = 2 over 640 positions (past its 512 window, so a window
    fault shows): the module, the step's leaves and batch, and the reference
    path's and f32 gradients."""
    cs = _load("chip_smoke.py")
    cfg = get_config("gemma3-1b").reduced().replace(dtype="bfloat16")
    params = cs.tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves, treedef = cs.tree_flatten(params)
    batch = next(cs.lm_driver.client_streams(cfg, 1, 2, 640)[0])
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = cfg.replace(kernel_impl="reference")
    _, g_t = cs.loss_and_grads(ref.replace(dtype="float32"), leaves, treedef, batch, f32=True)
    _, g_r = cs.loss_and_grads(ref, leaves, treedef, batch)
    return cs, cfg, leaves, treedef, batch, g_r, g_t


def test_phase15_gradient_check_passes_the_plain_path(_phase15_grads):
    cs, cfg, leaves, treedef, batch, g_r, g_t = _phase15_grads
    _, g_k = cs.loss_and_grads(cfg, leaves, treedef, batch)
    scale, ratio = cs.grad_gaps(g_k, g_r, g_t)
    assert scale <= cs.GRAD_SCALE_TOL and ratio <= cs.GRAD_RATIO_TOL, (scale, ratio)


# the CPU's plain flash backward has no sum pass to plant a fault in
CPU_FAULTS = ["K5 output x1.01", "K5 window - 1", "K6 dq x1.01", "K7 dk, dv x1.01",
              "K6, K7 window - 1", "K4 output x1.01"]


@pytest.mark.parametrize("name", CPU_FAULTS)
def test_phase15_gradient_check_fails_a_planted_fault(_phase15_grads, name):
    cs, cfg, leaves, treedef, batch, g_r, g_t = _phase15_grads
    assert set(CPU_FAULTS) < set(cs.GRAD_FAULTS)
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in cs.GRAD_FAULTS[name]]
    try:
        for mod, attr, wrap in cs.GRAD_FAULTS[name]:
            setattr(mod, attr, wrap(getattr(mod, attr)))
        _, g_f = cs.loss_and_grads(cfg, leaves, treedef, batch)
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)
    scale, ratio = cs.grad_gaps(g_f, g_r, g_t)
    assert scale > cs.GRAD_SCALE_TOL or ratio > cs.GRAD_RATIO_TOL, (scale, ratio)


_PTXAS_NS = "_ZN50_GLOBAL__N__8a88681c_17_flash_gqa_sm90_cu_36f005a1"


_DQ64 = (f"{_PTXAS_NS}16dq_narrow_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_S1_PKfS3_"
         "PvNS_5ShapeE")


@pytest.mark.parametrize("fault", [None, "spill", "wgmma", "wgmma_unnamed"])
def test_ptxas_report_names_each_kernel_and_fails_on_a_spill(monkeypatch, capsys, fault):
    """``chip_smoke.print_ptxas`` names each kernel of the build log by its
    mangled identifier's length prefix (the anonymous namespace's own name
    ends in digits, and the kernels' template arguments hold digits), prints
    its registers and spills and ptxas's notes about wgmma, and fails naming
    the kernel that spills or whose wgmma ptxas serialized (C7515 / C7520):
    the function the note names, or else the kernel whose section it falls
    in.  A report with neither passes, also where another line names wgmma
    (nvcc's note of an unused wgmma helper)."""
    cs = _load("chip_smoke.py")
    entry = "ptxas info    : Compiling entry function '{}' for 'sm_90a'"
    props = "ptxas info    : Function properties for {}"
    note = ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are "
            "serialized due to non wgmma instructions defining accumulator registers of a wgmma "
            "between start and end of the pipeline stage")
    kernels = [(f"{_PTXAS_NS}10dkv_kernelILi256ELb1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_PvS4_"
                "NS_5ShapeE", "dkv_kernel<256, 1>", 0),
               (f"{_PTXAS_NS}17dkv_narrow_kernelILi80ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_"
                "S1_PKfS3_PvS4_NS_5ShapeE", "dkv_narrow_kernel<80, 1>", 8 if fault == "spill" else 0),
               (_DQ64, "dq_narrow_kernel<64, 0>", 0),
               (f"{_PTXAS_NS}14dkv_sum_kernelEPKfS1_P13__nv_bfloat16S3_xii", "dkv_sum_kernel<>",
                0)]
    unused = ('flash_gqa_sm90.cu(286): warning #177-D: function "<unnamed>::wgmma_ss<N,kTransB>('
              'float (&)[<expression>], uint64_t, uint64_t, int) [with N=64, kTransB=1]" was '
              'declared but never referenced')
    lines = [unused]
    for mangled, _, spilled in kernels:
        lines.append(entry.format(mangled))
        if mangled == _DQ64 and fault == "wgmma":
            lines.append(f"{note} in the function '{_DQ64}'")
        elif mangled == _DQ64 and fault == "wgmma_unnamed":
            lines.append(note)
        lines += [props.format(mangled),
                  f"    0 bytes stack frame, {spilled} bytes spill stores, {spilled} bytes spill "
                  "loads",
                  "ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem"]
    monkeypatch.setattr(cs.kernel_build, "build_log", lambda source: "\n".join(lines))
    if fault is None:
        cs.print_ptxas("flash_gqa_sm90.cu")
    else:
        name = "dkv_narrow_kernel<80, 1>" if fault == "spill" else "dq_narrow_kernel<64, 0>"
        with pytest.raises(AssertionError, match=re.escape(name)) as err:
            cs.print_ptxas("flash_gqa_sm90.cu")
        assert str(err.value).count("_kernel<") == 1  # that kernel alone
    out = capsys.readouterr().out
    for _, name, _ in kernels:
        assert f"build[ptxas {name}]: Used 168 registers" in out, name
    if fault and fault.startswith("wgmma"):
        assert "build[ptxas]: ptxas info    : (C7520) Potential Performance Loss: wgmma" in out


def test_ptxas_report_fails_on_an_expected_kernel_it_does_not_name(monkeypatch, capsys):
    """``chip_smoke.print_ptxas(source, expect)`` fails naming each kernel
    of ``expect`` that the report does not name (phase 2 expects f32 K5's
    ``fwd_tf32_kernel`` at 64, 80 and 128), and reads its template argument
    from the mangled name."""
    cs = _load("chip_smoke.py")
    ns = "_ZN45_GLOBAL__N__5e2b3c1d_12_flash_gqa_cu_6f1e2a0b"
    lines = [f"ptxas info    : Compiling entry function '{ns}15fwd_tf32_kernelILi80EEEvPKfS1_S1_"
             "PfS2_NS_5ShapeE' for 'sm_90a'",
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
             "ptxas info    : Used 128 registers, used 1 barriers"]
    monkeypatch.setattr(cs.kernel_build, "build_log", lambda source: "\n".join(lines))
    cs.print_ptxas("flash_gqa.cu", ["fwd_tf32_kernel<80>"])
    assert "build[ptxas fwd_tf32_kernel<80>]: Used 128 registers" in capsys.readouterr().out
    with pytest.raises(AssertionError, match=re.escape("fwd_tf32_kernel<64>")) as err:
        cs.print_ptxas("flash_gqa.cu", ["fwd_tf32_kernel<80>", "fwd_tf32_kernel<64>"])
    assert "fwd_tf32_kernel<80>" not in str(err.value)


@pytest.mark.parametrize("kernel,family", [
    ("void (anonymous namespace)::fwd_narrow_kernel<128>(CUtensorMap_st, CUtensorMap_st)",
     "flash_fwd (K5)"),
    ("void (anonymous namespace)::fwd_kernel<256>(CUtensorMap_st)", "flash_fwd (K5)"),
    ("void (anonymous namespace)::dq_narrow_kernel<64, false>(CUtensorMap_st)",
     "flash_bwd_dq (K6)"),
    ("void (anonymous namespace)::dkv_narrow_kernel<80, true>(CUtensorMap_st)",
     "flash_bwd_dkv (K7)"),
    ("void (anonymous namespace)::dkv_sum_kernel(float const*, float const*)",
     "flash_bwd_dkv sum pass (K7)"),
    ("void (anonymous namespace)::dq_tf32_kernel<64>(float const*, float const*)",
     "flash_bwd_dq (K6)"),
    ("void (anonymous namespace)::dkv_tf32_kernel<128>(float const*, float const*)",
     "flash_bwd_dkv (K7)"),
    ("void (anonymous namespace)::dq_wgmma_kernel<64>(float const*, float const*)",
     "flash_bwd_dq (K6)"),
    ("void (anonymous namespace)::dkv_wgmma_kernel<80>(float const*, float const*)",
     "flash_bwd_dkv (K7)"),
    ("void (anonymous namespace)::fwd_tf32_kernel<64>(float const*, float const*)",
     "flash_fwd (K5)")])
def test_profile_lm_step_names_every_flash_kernel(kernel, family):
    """``launch/profile_lm_step.py`` sorts device time by kernel family from
    the kernels' names: the narrow kernels (D = 64, 80, and K5 at 128) and
    the f32 tensor-core kernels (K5's mma.sync, the dq and dk/dv passes'
    mma.sync and wgmma) count with their pass, not as other work."""
    from repro_torch.launch import profile_lm_step

    assert profile_lm_step.family(kernel) == family


class _LossyProfile:
    """A stand-in for ``torch.profiler.profile`` whose sessions lose their
    first ``lost[0]`` device events (the kernels; the sessions hold the
    rest), as sessions on the card did once another process had used it."""

    launched: list = []
    lost = [0]

    def __init__(self, activities):
        self.events = None

    def __enter__(self):
        _LossyProfile.launched = []
        return self

    def __exit__(self, *exc):
        from collections import Counter

        from torch.autograd import DeviceType

        kept = Counter(_LossyProfile.launched[_LossyProfile.lost[0]:])
        self.events = [type("Avg", (), dict(key=k, count=n, device_type=DeviceType.CUDA,
                                            self_device_time_total=2.0 * n))()
                       for k, n in kept.items()]

    def key_averages(self):
        return self.events


@pytest.mark.parametrize("lost", [0, 3, 100, 10**6])
def test_profile_opens_with_markers_so_a_lost_prefix_spares_the_body(monkeypatch, capsys, lost):
    """``chip_smoke.profiled`` opens each session with marker kernels and a
    synchronize: where a session loses its first device events, they are
    markers, and the body's events come back whole, markers left out; a
    session that keeps no marker is taken again with four times as many,
    and the next session opens with at least four times the most lost; a
    session that never keeps one fails the run.  ``device_ms`` counts its
    flushes on what comes back: 10 of 10."""
    cs = _load("chip_smoke.py")
    monkeypatch.setattr(torch.profiler, "profile", _LossyProfile)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: _LossyProfile.launched.append("spin_kernel(long)"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs, "PROFILE_PAD_S", 0.0)
    monkeypatch.setattr(_LossyProfile, "lost", [lost])

    def body():
        for _ in range(10):
            _LossyProfile.launched += ["flush", "k5"]

    if lost >= 64 * 4 ** (cs.PROFILE_TRIES - 1):
        with pytest.raises(AssertionError, match="no profile recorded one of its markers"):
            cs.profiled(body, [])
        return
    events = cs.profiled(body, [])
    assert sorted((e.key, e.count) for e in events) == [("flush", 10), ("k5", 10)]
    launch = {0: 64, 3: 64, 100: 400}[lost]
    assert cs.PROFILE_MARKERS == {"launch": launch, "lost": lost}
    out = capsys.readouterr().out
    assert (f"a session lost its first {lost} of" in out) == (lost > 0)
    flush = frozenset({"flush"})
    monkeypatch.setattr(cs, "l2_flush", lambda: (type("Buf", (), dict(
        bitwise_not_=lambda self: _LossyProfile.launched.append("flush")))(), flush))
    fn = lambda: _LossyProfile.launched.append("k5")  # noqa: E731
    assert cs.device_ms(fn) == 2.0 * 10 / 1e3 / 10


def _phase13_model(arch):
    cfg = get_config(arch).reduced().replace(dtype="bfloat16")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    streams = lm_driver.client_streams(cfg, 2, 2, 256)
    return cfg, params, [{k: torch.from_numpy(v) for k, v in next(s).items()} for s in streams]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_phase13_token_nll_gives_the_models_loss(arch):
    """``chip_smoke.token_nll``: one NLL a label position, and their mean
    plus the MoE aux loss is ``tf.lm_loss``."""
    cs = _load("chip_smoke.py")
    cfg, params, batches = _phase13_model(arch)
    nll, loss = cs.token_nll(params, cfg, batches[0])
    assert nll.shape == batches[0]["labels"].shape and nll.dtype == torch.float32
    with torch.no_grad():
        want = tf.lm_loss(params, cfg, batches[0]).item()
    assert loss == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_phase13_loss_check_passes_the_plain_path_and_fails_each_planted_fault(arch):
    """``chip_smoke.train_loss_check`` on the CPU (the kernels' plain
    versions against the oracles, in bf16, 2 x 256 tokens a batch): the
    kernel path's median NLL error against the f32 run is within
    ``TRAIN_NLL_RATIO_TOL`` of the reference path's, and a planted fault
    reads above it: each of ``TRAIN_FAULTS`` on the routed model, K4's
    output x1.01 on zamba2 (K5's moves its loss too little there, as on
    the card)."""
    cs = _load("chip_smoke.py")
    cfg, params, batches = _phase13_model(arch)
    plants = cs.TRAIN_FAULTS if cfg.n_experts else ("K4 output x1.01",)
    gap, ratio, faults, line = cs.train_loss_check(
        params, cfg, cfg.replace(kernel_impl="reference"), batches, plants)
    assert "mean loss over 2 client batches" in line and math.isfinite(gap), line
    assert ratio <= cs.TRAIN_NLL_RATIO_TOL, line
    assert set(cs.TRAIN_FAULTS) <= set(cs.GRAD_FAULTS) and list(faults) == list(plants)
    assert all(v > cs.TRAIN_NLL_RATIO_TOL for v in faults.values()), line
    assert line.count("loss rel diff") == len(plants), line


def test_phase15_internvl2_batches_have_the_token_batch_layout():
    """Phase 15's internvl2-2b batches (``chip_smoke.launch_step_batches``;
    the LM driver's streams refuse the vision frontend): one client's T
    batches in ``steps.token_batch``'s layout and dtypes, each leaf (1, T,
    ...) as the dry run's meta inputs are, so the step's argument bytes are
    the count's; tokens and labels within the vocabulary, the patches
    finite and not all alike, and the same from its seed on every call."""
    from repro_torch.launch import steps

    cs = _load("chip_smoke.py")
    cfg = get_config("internvl2-2b")
    got = cs.launch_step_batches(cfg, device="cpu")
    t = cs.LM["local_iters"]
    spec = steps.token_batch(cfg, cs.LM["batch"], cs.LM["seq_len"])
    counted = steps.input_specs(cfg, cs.LAUNCH_SHAPE, micro_batch=cs.LM["batch"])["batches"]
    assert set(got) == set(spec) == set(counted) == {"tokens", "labels", "patch_embeds"}
    for k, (shape, dtype) in spec.items():
        assert got[k].shape == (1, t) + shape == counted[k].shape, k
        assert got[k].dtype == dtype == counted[k].dtype, k
    assert got["patch_embeds"].shape[-2:] == (cfg.n_patches, cfg.d_vision)
    assert got["tokens"].shape[-1] == cs.LM["seq_len"] - cfg.n_patches
    for k in ("tokens", "labels"):
        assert 0 <= got[k].min() and got[k].max() < cfg.vocab_size, k
    assert torch.isfinite(got["patch_embeds"]).all() and got["patch_embeds"].std() > 0.5
    again = cs.launch_step_batches(cfg, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_phase15_archs_plant_faults_of_the_kernels_they_run():
    """Phase 15's archs (``LAUNCH_ARCHS``): gemma3-1b plants every fault
    of ``GRAD_FAULTS``; internvl2-2b (head_dim 128, no window) names keys of
    ``GRAD_FAULTS`` only, one for each of K5, K6, K7 and the sum pass (its
    G = 2 runs it), and no window fault; granite-moe-1b-a400m runs in f32,
    which has no sum pass and no window fault to plant, and names K5, K6,
    K7 and K4; each arch's parameter count is its config's."""
    from repro_torch.launch import steps

    cs = _load("chip_smoke.py")
    assert list(cs.LAUNCH_ARCHS) == ["gemma3-1b", "internvl2-2b", "granite-moe-1b-a400m"]
    assert cs.LAUNCH_ARCHS["gemma3-1b"] == (cs.LM_N, tuple(cs.GRAD_FAULTS), "bfloat16")
    _, faults, dtype = cs.LAUNCH_ARCHS["granite-moe-1b-a400m"]
    assert dtype == "float32" and set(faults) <= set(cs.GRAD_FAULTS)
    assert {name.split()[0] for name in faults} == {"K4", "K5", "K6", "K7"}
    assert not any("window" in name or "sum pass" in name for name in faults)
    n, faults, dtype = cs.LAUNCH_ARCHS["internvl2-2b"]
    assert dtype == "bfloat16"
    cfg = get_config("internvl2-2b")
    assert cfg.head_dim == 128 and cfg.n_heads // cfg.n_kv_heads == 2
    assert all(layer.window is None for layer in cfg.layers)
    assert set(faults) <= set(cs.GRAD_FAULTS) and len(set(faults)) == len(faults) == 4
    assert not any("window" in name for name in faults)
    assert {name.split()[0] for name in faults} == {"K5", "K6", "K7"}
    assert "K7 sum pass x1.01" in faults
    for arch, (count, _, _) in cs.LAUNCH_ARCHS.items():
        params = steps.abstract_params(get_config(arch))
        assert sum(x.numel() for x in cs.tree_leaves(params)) == count, arch


def test_planted_puts_the_kernels_back():
    """``chip_smoke.planted`` swaps each planted kernel in inside the
    ``with`` and puts the kernels back after it, also where it raises."""
    cs = _load("chip_smoke.py")
    plants = cs.GRAD_FAULTS["K6, K7 window - 1"] + cs.GRAD_FAULTS["K4 output x1.01"]
    kept = [getattr(mod, attr) for mod, attr, _ in plants]
    with pytest.raises(RuntimeError):
        with cs.planted(plants):
            assert all(getattr(mod, attr) is not fn for (mod, attr, _), fn in zip(plants, kept))
            raise RuntimeError
    assert [getattr(mod, attr) for mod, attr, _ in plants] == kept


def test_one_product_control_cuts_every_tensor_core_product_to_one():
    """``scripts/tf32_one_product.py`` (the f32 limits' control) leaves one
    TF32 product (hi*hi) in ``mma3``, through which the mma.sync kernels'
    products all go (K5's ``fwd_tf32_kernel`` among them), and in each run
    of three wgmma products; the rest of the source stays as it is."""
    from repro_torch.kernels.flash_gqa import ops as flash_ops

    control = _load("scripts/tf32_one_product.py")
    src = flash_ops.SOURCE.read_text()
    out = control.one_product(src)
    mma3 = re.search(r"void mma3\(.*?\n}", out, re.S).group(0)
    assert re.findall(r"mma_tf32\(c, a\[0\]\.(\w+), .*?, b0\.(\w), b1\.(\w)\);", mma3) == [
        ("hi", "x", "x")]
    assert len(re.findall(r"wgmma_tf32(?:<\w+>|_ss)\(", out)) == len(
        re.findall(r"wgmma_tf32(?:<\w+>|_ss)\(", src)) - 2 * 6
    for kernel in control.MMA_SYNC_KERNELS:
        head = kernel + "(const float* __restrict__ q"
        body = re.search(re.escape(head) + r".*?\n}", src, re.S).group(0)
        assert body in out, kernel
