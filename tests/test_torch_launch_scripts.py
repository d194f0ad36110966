"""The port's scripts and quickstart (``scripts/torch_*.py``,
``examples/torch_quickstart.py``), each run in this process with ``--device
cpu`` at its reduced size: the assertions each script makes (finite losses,
the quickstart's convergence) hold, and the roofline table reads the dry
run's and the calibration's records.  Each imports nothing of JAX or
``repro`` and asks for the card unless told otherwise.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import calibrate, dryrun, roofline

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


@pytest.mark.parametrize("spill", [False, True])
def test_ptxas_report_names_each_kernel_and_fails_on_a_spill(monkeypatch, capsys, spill):
    """``chip_smoke.print_ptxas`` names each kernel of the build log by its
    mangled identifier's length prefix (the anonymous namespace's own name
    ends in digits, and the D = 80 kernels' names hold digits), prints its
    registers and spills, passes on ptxas's notes about wgmma, and fails
    naming the kernel that spills."""
    cs = _load("chip_smoke.py")
    entry = "ptxas info    : Compiling entry function '{}' for 'sm_90a'"
    props = "ptxas info    : Function properties for {}"
    kernels = [(f"{_PTXAS_NS}10dkv_kernelILi256ELb1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_PvS4_"
                "NS_5ShapeE", "dkv_kernel<256, 1>", 0),
               (f"{_PTXAS_NS}14dkv_d80_kernelILb1ELb0EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_S1_"
                "PKfS3_PvS4_NS_5ShapeE", "dkv_d80_kernel<1, 0>", 8 if spill else 0),
               (f"{_PTXAS_NS}13dq_d80_kernelILb0ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_S1_"
                "PKfS3_PvNS_5ShapeE", "dq_d80_kernel<0, 1>", 0),
               (f"{_PTXAS_NS}14dkv_sum_kernelEPKfS1_P13__nv_bfloat16S3_xii", "dkv_sum_kernel<>",
                0)]
    lines = []
    for mangled, _, spilled in kernels:
        lines += [entry.format(mangled), props.format(mangled),
                  f"    0 bytes stack frame, {spilled} bytes spill stores, {spilled} bytes spill "
                  "loads",
                  "ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem"]
    lines.append("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
                 "instructions are serialized")
    monkeypatch.setattr(cs.kernel_build, "build_log", lambda source: "\n".join(lines))
    if spill:
        with pytest.raises(AssertionError, match=r"dkv_d80_kernel<1, 0>"):
            cs.print_ptxas("flash_gqa_sm90.cu")
    else:
        cs.print_ptxas("flash_gqa_sm90.cu")
    out = capsys.readouterr().out
    for _, name, _ in kernels:
        assert f"build[ptxas {name}]: Used 168 registers" in out, name
    assert "build[ptxas]: ptxas info    : (C7515) Potential Performance Loss: wgmma" in out
