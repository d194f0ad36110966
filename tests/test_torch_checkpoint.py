"""Checkpoint/resume of the port's two drivers, held against an
uninterrupted run of the port (``tests/test_checkpoint_resume.py``'s
contract): run-to-2R equals run-to-R -> save -> fresh driver -> restore ->
run-to-2R, bit for bit, for the sync and the async driver, with the async
cut landing mid-simulation (scheduler heap, in-flight results, a partly
filled buffer), in the middle of a delivered cohort, and at a non-final
flush of a multi-flush delivery.  A restore across drivers or configs is
refused.  The checkpoint layout itself: tensors (bf16 by their bit
pattern) and numpy leaves round-trip exactly.  The CLI resumes and
traces, and refuses the flags that are not ported yet.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs.resnet_cifar import SMALL_CNN as CFG
from repro_torch.core.baselines import METHODS
from repro_torch.core.pfedsop import ClientState
from repro_torch.data import FederatedData, dirichlet_partition, make_class_conditional_images
from repro_torch.fl import (
    AsyncConfig,
    AsyncFederation,
    AvailabilityConfig,
    Federation,
    FLRunConfig,
    masked_accuracy,
)
from repro_torch.launch import train_federated
from repro_torch.models import cnn
from repro_torch.utils.checkpoint import (
    latest_step,
    load_checkpoint,
    read_manifest,
    restore_rng_state,
    rng_state_tree,
    save_checkpoint,
)

HETERO = AvailabilityConfig(speed="lognormal", sigma=1.0, availability=0.3, mean_on=4.0)


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
    images, labels = make_class_conditional_images(800, CFG.n_classes,
                                                   CFG.cnn_image_size, seed=0)
    parts = dirichlet_partition(labels, 8, alpha=0.3, seed=0)
    data = FederatedData.from_partition(images, labels, parts, seed=0)
    params = cnn.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    loss = lambda p, b: cnn.loss_fn(p, CFG, b)
    acc = masked_accuracy(lambda p, t: cnn.apply(p, CFG, t["images"]))
    return data, params, loss, acc


def _cfg(rounds=4, **kw):
    return FLRunConfig(n_clients=8, participation=0.5, rounds=rounds, batch=8,
                       local_iters=2, seed=1, **kw)


def _sync(setup, cfg, method="pfedsop"):
    data, params, loss, acc = setup
    return Federation(METHODS[method](), loss, acc, params, data, cfg, device="cpu")


def _async(setup, cfg, acfg=None, method="pfedsop"):
    data, params, loss, acc = setup
    return AsyncFederation(METHODS[method](), loss, acc, params, data, cfg, acfg,
                           device="cpu")


def _assert_same(resumed, full, keys=("loss", "acc", "sim_time", "mean_best_acc")):
    for key in keys:
        assert resumed[key] == full[key], key


def test_rng_state_roundtrip(tmp_path):
    rng = np.random.RandomState(123)
    rng.normal(size=7)  # leave a cached gaussian in the state
    save_checkpoint(tmp_path, 0, {"rng": rng_state_tree(rng)})
    tree, _ = load_checkpoint(tmp_path, {"rng": rng_state_tree(np.random.RandomState(0))})
    rng2 = np.random.RandomState(0)
    restore_rng_state(rng2, tree["rng"])
    np.testing.assert_array_equal(rng.normal(size=16), rng2.normal(size=16))
    np.testing.assert_array_equal(rng.choice(100, 10, replace=False),
                                  rng2.choice(100, 10, replace=False))


def test_tree_roundtrip_is_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {
        "state": ClientState(params=torch.randn(3, 5, generator=g).bfloat16(),
                             delta=torch.randn(3, 5, generator=g),
                             has_delta=torch.tensor([True, False, True]),
                             rounds_seen=torch.tensor([1, 0, 2], dtype=torch.int32)),
        "hist": np.array([0.25, 1e-300], np.float64),
        "seq": [np.int64(7), torch.tensor(-0.0)],
    }
    save_checkpoint(tmp_path, 3, tree, extra={"round": 3})
    mani = read_manifest(tmp_path)
    assert mani["names"][:2] == ["hist", "seq/0"] and "state/params" in mani["names"]
    assert mani["dtypes"][mani["names"].index("state/params")] == "bfloat16"
    got, extra = load_checkpoint(tmp_path, tree)
    assert extra == {"round": 3} and isinstance(got["state"], ClientState)
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for a, b in zip(got["state"], tree["state"]):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))
    assert np.array_equal(got["hist"], tree["hist"]) and got["seq"][0] == 7
    assert torch.signbit(got["seq"][1])


def test_sync_resume_matches_uninterrupted(setup, tmp_path):
    full = _sync(setup, _cfg()).run()
    cfg = _cfg(ckpt_every=2, ckpt_dir=str(tmp_path / "sync"))
    _sync(setup, cfg).run()
    assert latest_step(cfg.ckpt_dir) == 4  # saved at rounds 2 and 4
    assert read_manifest(cfg.ckpt_dir, 2)["extra"]["driver"] == "sync"
    fed = _sync(setup, cfg)
    assert fed.restore(step=2) == 2
    _assert_same(fed.run(), full)


@pytest.mark.parametrize("method", ["pfedsop", "fedavg", "scaffold"])
def test_async_resume_matches_uninterrupted(setup, tmp_path, method):
    acfg = AsyncConfig(buffer_size=2, concurrency=4, availability=HETERO)
    full = _async(setup, _cfg(), acfg, method).run()
    cfg = _cfg(ckpt_every=2, ckpt_dir=str(tmp_path / f"async_{method}"))
    _async(setup, cfg, acfg, method).run()
    mani = read_manifest(cfg.ckpt_dir, 2)["extra"]
    assert mani["driver"] == "async" and mani["n_pending"] > 0
    fed = _async(setup, cfg, acfg, method)
    assert fed.restore(step=2) == 2
    _assert_same(fed.run(), full, ("loss", "acc", "sim_time", "staleness",
                                   "mean_best_acc"))


def test_async_resume_mid_cohort_flush(setup, tmp_path):
    """buffer_size=3 does not divide the simultaneously delivered K'=4
    cohort, so the checkpoint of each flush holds part of that cohort in
    the buffer."""
    acfg = AsyncConfig(buffer_size=3)
    full = _async(setup, _cfg(rounds=5), acfg).run()
    cfg = _cfg(rounds=5, ckpt_every=1, ckpt_dir=str(tmp_path / "midflush"))
    _async(setup, cfg, acfg).run()
    assert read_manifest(cfg.ckpt_dir, 2)["extra"]["n_buffer"] > 0
    fed = _async(setup, cfg, acfg)
    assert fed.restore(step=2) == 2
    _assert_same(fed.run(), full, ("loss", "acc", "staleness"))


def test_async_resume_from_intermediate_flush(setup, tmp_path):
    """A checkpoint written by a non-final flush of a multi-flush delivery
    still holds >= buffer_size uploads; the resumed run drains them before
    its next dispatch, as the uninterrupted run did."""
    acfg = AsyncConfig(buffer_size=1, concurrency=4)
    full = _async(setup, _cfg(rounds=8), acfg).run()
    cfg = _cfg(rounds=8, ckpt_every=1, ckpt_dir=str(tmp_path / "interflush"))
    _async(setup, cfg, acfg).run()
    assert read_manifest(cfg.ckpt_dir, 1)["extra"]["n_buffer"] >= acfg.buffer_size
    fed = _async(setup, cfg, acfg)
    assert fed.restore(step=1) == 1
    _assert_same(fed.run(), full, ("loss", "acc", "staleness", "sim_time",
                                   "mean_best_acc"))


def test_sync_restore_refuses_async_checkpoint(setup, tmp_path):
    cfg = _cfg(rounds=2, ckpt_every=2, ckpt_dir=str(tmp_path / "mix2"))
    _async(setup, cfg, AsyncConfig()).run()
    with pytest.raises(ValueError, match="driver"):
        _sync(setup, cfg).restore()


def test_async_restore_refuses_sync_checkpoint(setup, tmp_path):
    cfg = _cfg(rounds=2, ckpt_every=2, ckpt_dir=str(tmp_path / "mix"))
    _sync(setup, cfg).run()
    with pytest.raises(ValueError, match="driver"):
        _async(setup, cfg).restore()


def test_sync_restore_refuses_config_mismatch(setup, tmp_path):
    cfg = _cfg(rounds=2, ckpt_every=2, ckpt_dir=str(tmp_path / "syncmix"))
    _sync(setup, cfg).run()
    with pytest.raises(ValueError, match="run config"):
        _sync(setup, replace(cfg, participation=0.25)).restore()


def test_async_restore_refuses_config_mismatch(setup, tmp_path):
    cfg = _cfg(rounds=2, ckpt_every=2, ckpt_dir=str(tmp_path / "asyncmix"))
    _async(setup, cfg, AsyncConfig(buffer_size=2)).run()
    with pytest.raises(ValueError, match="async config"):
        _async(setup, cfg, AsyncConfig(buffer_size=3)).restore()


def test_cli_async_checkpoint_resume_and_trace(tmp_path, capsys):
    base = ["--device", "cpu", "--samples", "200", "--clients", "4", "--participation",
            "0.5", "--local-iters", "1", "--mode", "async", "--speed", "lognormal",
            "--availability", "0.5", "--buffer-size", "1", "--methods", "pfedsop",
            "fedprox", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    full = train_federated.main(base + ["--rounds", "4", "--ckpt-dir", str(tmp_path / "x")])
    train_federated.main(base + ["--rounds", "2", "--trace-dir", str(tmp_path / "tr")])
    resumed = train_federated.main(base + ["--rounds", "4", "--resume"])
    assert "resumed from" in capsys.readouterr().out
    for name in ("pfedsop", "fedprox"):
        assert resumed[name]["loss"] == full[name]["loss"]
        assert resumed[name]["sim_time"] == full[name]["sim_time"]
        assert (tmp_path / "tr" / name / "events.jsonl").exists()


@pytest.mark.parametrize("flags, item", [(["--store", "host"], "item 12"),
                                          (["--store", "mmap"], "item 12"),
                                          (["--backend", "mesh"], "item 16"),
                                          (["--mesh", "pods:2x2x2"], "item 16")])
def test_cli_unported_flags_name_their_roadmap_item(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        train_federated.parse_args(["--device", "cpu"] + flags)
