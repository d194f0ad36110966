"""The port's observability: ``repro_torch.obs`` and ``kernel_scope``.

``obs/log.py``, ``obs/metrics.py`` and ``obs/trace.py`` are byte-equal
copies of ``repro``'s, so a traced run of the port writes ``repro``'s
trace schema and ``scripts/trace_report.py`` reads it unchanged.  Tracing
never touches computed values: a traced run (level ``kernel``, with a
``torch.profiler`` window) has the untraced history bit for bit, for the
sync and the async driver.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import dispatch as j_dispatch
from repro_torch.configs.resnet_cifar import SMALL_CNN as CFG
from repro_torch.core.baselines import PFedSOP
from repro_torch.data import FederatedData, dirichlet_partition, make_class_conditional_images
from repro_torch.fl import (
    AsyncConfig,
    AsyncFederation,
    AvailabilityConfig,
    Federation,
    FLRunConfig,
    masked_accuracy,
)
from repro_torch.kernels import dispatch
from repro_torch.models import cnn
from repro_torch.obs import NOOP, ObsConfig, get_obs, make_obs, read_events

REPO = Path(__file__).resolve().parents[1]
HETERO = AvailabilityConfig(speed="lognormal", sigma=1.0, availability=0.3, mean_on=4.0)

_spec = importlib.util.spec_from_file_location("trace_report",
                                               REPO / "scripts" / "trace_report.py")
trace_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_report)


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
    images, labels = make_class_conditional_images(400, CFG.n_classes,
                                                   CFG.cnn_image_size, seed=0)
    parts = dirichlet_partition(labels, 8, alpha=0.3, seed=0)
    data = FederatedData.from_partition(images, labels, parts, seed=0)
    params = cnn.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    loss = lambda p, b: cnn.loss_fn(p, CFG, b)
    acc = masked_accuracy(lambda p, t: cnn.apply(p, CFG, t["images"]))
    return data, params, loss, acc


def _run(setup, driver, obs=None, rounds=3):
    data, params, loss, acc = setup
    cfg = FLRunConfig(n_clients=8, participation=0.5, rounds=rounds, batch=8,
                      local_iters=2, seed=1, obs=obs)
    if driver == "sync":
        fed = Federation(PFedSOP(), loss, acc, params, data, cfg, device="cpu")
    else:
        fed = AsyncFederation(PFedSOP(), loss, acc, params, data, cfg,
                              AsyncConfig(buffer_size=2, availability=HETERO),
                              device="cpu")
    return fed, fed.run()


@pytest.mark.parametrize("name", ["log.py", "metrics.py", "trace.py"])
def test_framework_free_modules_are_byte_equal_copies(name):
    assert ((REPO / "src/repro_torch/obs" / name).read_bytes()
            == (REPO / "src/repro/obs" / name).read_bytes())


@pytest.mark.parametrize("driver", ["sync", "async"])
def test_traced_history_equals_untraced_bitwise(setup, driver, tmp_path):
    _, plain = _run(setup, driver)
    obs = ObsConfig(trace_dir=str(tmp_path / driver), level="kernel", profile_round=1)
    fed, traced = _run(setup, driver, obs)
    keys = ("loss", "acc", "sim_time") + (("staleness",) if driver == "async" else ())
    for key in keys:
        assert traced[key] == plain[key], key
    assert get_obs() is NOOP  # the closed run leaves no global tracer behind
    events = read_events(tmp_path / driver)
    names = {e.get("name") for e in events}
    assert {"run_start", "profile_start", "profile_stop"} <= names
    kernels = [e for e in events if e.get("name") == "kernel"]
    assert kernels and {e["args"]["kernel"] for e in kernels} == {"pfedsop_update"}
    profile = (tmp_path / driver / "torch_profile" / "round_00001.json").read_text()
    assert "pfedsop_update[auto]" in profile  # the record_function label
    assert (tmp_path / driver / "trace.json").exists()


@pytest.mark.parametrize("driver", ["sync", "async"])
def test_trace_report_reads_the_ports_trace(setup, driver, tmp_path, capsys):
    _run(setup, driver, ObsConfig(trace_dir=str(tmp_path / driver)))
    (run,) = trace_report.discover([tmp_path])
    rep = trace_report.report_run(run, top_k=3)
    assert rep["fingerprint"]["driver"] == driver
    assert {"gather", "client", "eval", "aggregate", "scatter"} <= set(rep["phases"])
    assert "pfedsop.beta" in rep["histograms"] and "client.loss" in rep["histograms"]
    if driver == "async":
        assert rep["stragglers"] and "async.tau" in rep["histograms"]
        assert rep["counters"]["versions"] == 3
    else:
        assert "round" in rep["phases"] and rep["counters"]["rounds"] == 3
    trace_report.print_run(rep)
    assert "phase" in capsys.readouterr().out
    metrics = [json.loads(line) for line in
               (tmp_path / driver / "metrics.jsonl").read_text().splitlines()]
    assert len(metrics) == 3


def test_trace_dir_refuses_another_config(setup, tmp_path):
    _run(setup, "sync", ObsConfig(trace_dir=str(tmp_path / "t")), rounds=1)
    _run(setup, "sync", ObsConfig(trace_dir=str(tmp_path / "t")), rounds=2)  # appends
    with pytest.raises(ValueError, match="fingerprint"):
        _run(setup, "async", ObsConfig(trace_dir=str(tmp_path / "t")), rounds=1)


def test_obs_off_is_the_noop_facade(tmp_path):
    assert make_obs(None) is NOOP
    off = make_obs({"trace_dir": str(tmp_path / "x"), "level": "off"})
    assert not off.enabled and off.open() is off
    assert not (tmp_path / "x").exists()
    with pytest.raises(ValueError, match="obs level"):
        ObsConfig(level="verbose")


def test_kernel_registry_matches_repro():
    assert set(dispatch.registered_kernels()) == set(j_dispatch.registered_kernels())
    with dispatch.kernel_scope("rmsnorm", "auto"):
        x = torch.ones(3) * 2
    assert torch.equal(x, torch.full((3,), 2.0))
