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
