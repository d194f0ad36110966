"""``repro_torch.launch.roofline`` against ``repro.launch.roofline`` and
against the bounds ``chip_smoke.py`` computed before it read them.

``model_flops`` and ``active_param_count`` are plain Python over the config:
exactly ``repro``'s for every arch x shape.  The roofline terms use the
H100's rates.  Each kernel's cost function is held to the byte and
operation counts that ``chip_smoke.py``'s bounds used when it wrote them out
itself, on the tensors of the shapes it times.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import roofline as j_roofline
from repro.launch import steps as j_steps
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.kernels.flash_gqa import grid
from repro_torch.kernels.pfedsop_update import ops as update_ops
from repro_torch.launch import roofline
from repro_torch.launch import steps as t_steps

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs files in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_active_params_equal_repro(arch, shape):
    t_cfg = t_steps.resolve_cfg(get_config(arch), INPUT_SHAPES[shape])
    j_cfg = j_steps.resolve_cfg(j_get_config(arch), J_INPUT_SHAPES[shape])
    assert roofline.active_param_count(t_cfg) == j_roofline.active_param_count(j_cfg)
    assert (roofline.model_flops(t_cfg, INPUT_SHAPES[shape])
            == j_roofline.model_flops(j_cfg, J_INPUT_SHAPES[shape]))


def test_h100_constants_and_no_tpu_ones():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.F32_FLOPS, roofline.NVLINK_BW,
            roofline.HBM_CAPACITY) == (989e12, 3.35e12, 67e12, 450e9, 80e9)
    src = (ROOT / "src/repro_torch/launch/roofline.py").read_text()
    for tpu in (r"197e12", r"819e9", r"(?<![\d.])50e9", r"\bICI"):
        assert not re.search(tpu, src), tpu
    assert not hasattr(roofline, "collective_bytes_from_hlo")


def test_roofline_terms_dominance_on_h100_rates():
    record = {
        "cost_analysis": {"flops": 989e12, "bytes accessed": 3.35e12 * 2},
        "collectives": {"all-reduce": {"bytes": 450e9 * 0.5, "count": 1}},
    }
    rl = roofline.roofline_terms(record, n_devices=4)
    np.testing.assert_allclose(rl["compute_s"], 1.0)
    np.testing.assert_allclose(rl["memory_s"], 2.0)
    np.testing.assert_allclose(rl["collective_s"], 0.5)
    assert rl["dominant"] == "memory"
    assert rl["total_flops"] == 4 * 989e12 and rl["collective_bytes_per_device"] == 225e9
    # one device: no collective census, no collective term
    rl = roofline.roofline_terms({"cost_analysis": {"flops": 2 * 989e12, "bytes accessed": 1.0},
                                  "collectives": {}}, n_devices=1)
    assert rl["dominant"] == "compute" and rl["collective_s"] == 0.0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _old_bound(nbytes, nops, ops_per_s):
    """``chip_smoke.py``'s ``bound`` as it was before it read ``roofline``."""
    t_bytes, t_ops = nbytes / 3.35e12, nops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _flash_case(b, s, h, kv, d, window):
    q, do = _meta(b, s, h, d, dtype=torch.bfloat16), _meta(b, s, h, d, dtype=torch.bfloat16)
    k, v = _meta(b, s, kv, d, dtype=torch.bfloat16), _meta(b, s, kv, d, dtype=torch.bfloat16)
    lse = _meta(b, h, s)
    pairs = b * h * grid.attention_pairs(s, window)
    io, rows = q.nbytes + k.nbytes + v.nbytes, lse.nbytes
    args = (b, s, h, kv, d, window, 2)
    return [
        (roofline.flash_fwd_cost(*args), io + q.nbytes + rows, 4 * d * pairs, 989e12),
        (roofline.flash_dq_cost(*args), io + 2 * do.nbytes + 2 * rows, 6 * d * pairs, 989e12),
        (roofline.flash_dkv_cost(*args), io + do.nbytes + 2 * rows + k.nbytes + v.nbytes,
         8 * d * pairs, 989e12),
    ]


def _cases():
    main_c, main_n, lm_n = 20, 1_249_956, 999_826_048
    x, dg = _meta(main_c, main_n), _meta(main_n)
    tiles = update_ops.n_tiles(main_n)
    partials = _meta(main_c, tiles, 3)
    out = [
        ("K1 C=20", roofline.reduce3_cost(main_c, main_n, tiles, 4),
         x.nbytes + dg.nbytes + partials.nbytes, 6 * main_c * main_n, 67e12),
        ("K2 C=20", roofline.update_cost(main_c, main_n, 4),
         3 * x.nbytes + dg.nbytes + 4 * main_c + 4 * main_c, 5 * main_c * main_n, 67e12),
        ("K1 C=1", roofline.reduce3_cost(1, lm_n, update_ops.n_tiles(lm_n), 4),
         2 * 4 * lm_n + update_ops.n_tiles(lm_n) * 12, 6 * lm_n, 67e12),
        ("K2 C=1", roofline.update_cost(1, lm_n, 4), 3 * 4 * lm_n + 4 * lm_n + 8,
         5 * lm_n, 67e12),
    ]
    xr, sc = _meta(4096, 1152, dtype=torch.bfloat16), _meta(1152, dtype=torch.bfloat16)
    out.append(("K4", roofline.rmsnorm_cost(4096, 1152, 2), 2 * xr.nbytes + sc.nbytes,
                4 * xr.numel(), 989e12))
    for b, s, h, kv, d, window in ((2, 2048, 4, 1, 256, None), (2, 2048, 4, 1, 256, 512),
                                   (2, 2048, 32, 32, 80, None)):
        for name, case in zip(("K5", "K6", "K7"), _flash_case(b, s, h, kv, d, window)):
            out.append((f"{name} H={h} KV={kv} D={d} window={window}",) + case)
    pk, dk = _meta(2, 2048, 4, 256), _meta(2, 2048, 1, 256, dtype=torch.bfloat16)
    out.append(("K7 sum", roofline.flash_dkv_sum_cost(2, 2048, 4, 1, 256),
                2 * pk.nbytes + 2 * dk.nbytes, 2 * (4 - 1) * dk.numel(), 67e12))
    return out


CASES = _cases()


@pytest.mark.parametrize("label,cost,nbytes,nops,peak", CASES, ids=[c[0] for c in CASES])
def test_kernel_cost_equals_the_chip_smoke_count(label, cost, nbytes, nops, peak):
    assert cost == {"flops": float(nops), "bytes": float(nbytes), "peak": peak}
    assert roofline.bound_ms(cost) == _old_bound(nbytes, nops, peak)


def test_chip_smoke_reads_its_rates_and_counts_from_roofline():
    src = (ROOT / "chip_smoke.py").read_text()
    for literal in ("3.35e12", "989e12", "67e12"):
        assert literal not in src
    assert "roofline.bound_ms(cost)" in src
    for fn in ("reduce3_cost", "update_cost", "rmsnorm_cost", "flash_fwd_cost",
               "flash_dq_cost", "flash_dkv_cost", "flash_dkv_sum_cost"):
        assert f"roofline.{fn}(" in src


def test_kernel_costs_live_with_the_kernels():
    """The kernel layer reads its costs from ``kernels/costs.py`` and imports
    nothing of the launch layer; ``roofline`` re-exports the same objects."""
    from repro_torch.kernels import costs

    for fn in ("PEAK_FLOPS", "F32_FLOPS", "HBM_BW", "bound_ms", "reduce3_cost", "update_cost",
               "rmsnorm_cost", "flash_fwd_cost", "flash_dq_cost", "flash_dkv_cost",
               "flash_dkv_sum_cost"):
        assert getattr(roofline, fn) is getattr(costs, fn), fn
    for path in sorted((ROOT / "src/repro_torch/kernels").rglob("*.py")):
        assert not re.search(r"^\s*(from|import) repro_torch\.launch", path.read_text(), re.M), path


@pytest.mark.parametrize("shape", [(2, 2048, 16, 8, 64, None), (2, 2048, 16, 8, 128, None),
                                   (2, 2048, 32, 32, 80, None), (4, 64, 4, 1, 64, 512)],
                         ids=["granite-moe", "internvl2", "zamba2", "reduced"])
@pytest.mark.parametrize("cost", ["flash_fwd_cost", "flash_dq_cost", "flash_dkv_cost"])
def test_f32_flash_launch_runs_at_a_third_of_the_tf32_rate(cost, shape):
    """An f32 launch of K5, K6 or K7 is bounded at three TF32 products a
    flop (``TF32_FLOPS / 3``: an f32-accurate product on the tensor cores
    is hi*hi + hi*lo + lo*hi of operands split into TF32 halves); bf16 at
    the bf16 peak.  The same shape's f32 and bf16 costs count the same
    FLOPs, so their operation times differ by exactly that rate."""
    from repro_torch.kernels import costs

    assert roofline.TF32_FLOPS == costs.TF32_FLOPS == 495e12
    assert roofline.flash_peak is costs.flash_peak
    fn = getattr(roofline, cost)
    bf16, f32 = fn(*shape, 2), fn(*shape, 4)
    assert bf16["peak"] == roofline.PEAK_FLOPS == costs.flash_peak(2)
    assert f32["peak"] == roofline.TF32_FLOPS / 3 == costs.flash_peak(4)
    assert f32["flops"] == bf16["flops"] > 0
    assert f32["flops"] / f32["peak"] == pytest.approx(
        bf16["flops"] / bf16["peak"] * 3 * 989e12 / 495e12, rel=1e-12)
