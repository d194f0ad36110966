"""Roofline terms on the H100, with the kernels' costs re-exported.

Port of ``repro/launch/roofline.py`` with the H100 SXM's data-sheet rates
in place of the TPU's.  Three terms per step record (``launch/dryrun.py``):

  compute    = counted FLOPs  / 989e12 FLOP/s (dense bf16, tensor cores)
  memory     = counted bytes  / 3.35e12 B/s   (HBM3)
  collective = collective bytes / 450e9 B/s   (NVLink, one direction)

``repro`` reads its collective bytes from the post-SPMD HLO
(``collective_bytes_from_hlo``).  The port has no HLO: its census is the
one ``launch/collectives.py`` keeps of its own ``torch.distributed`` calls,
in the same ``{op: {bytes, count}}`` schema (result bytes per rank), which
``roofline_terms`` reads.  The dry run's one-device step makes no
collective (census ``{}``, ``collective_s`` 0); on the 16x16 and 2x16x16
meshes it counts rank 0's calls (``launch/dryrun.py``).

``model_flops`` and ``active_param_count`` are plain Python over the config,
as in ``repro``.  The kernels' rates and their ``*_cost`` functions live
with the kernels (``repro_torch/kernels/costs.py``) and are re-exported
here, so ``chip_smoke.py``'s bounds and the dry run's census read one
count of each kernel's work.
"""
from __future__ import annotations

from repro_torch.kernels.costs import (  # noqa: F401  (re-exported)
    F32_FLOPS,
    HBM_BW,
    PEAK_FLOPS,
    TF32_FLOPS,
    bound_ms,
    flash_dkv_cost,
    flash_dkv_sum_cost,
    flash_dq_cost,
    flash_fwd_cost,
    flash_peak,
    reduce3_cost,
    rmsnorm_cost,
    update_cost,
)

NVLINK_BW = 450e9  # B/s per direction, H100 SXM (NVLink 4, 18 links)
HBM_CAPACITY = 80e9  # bytes of device memory, H100 80GB


def roofline_terms(record: dict, n_devices: int) -> dict:
    """Seconds per term + dominant bottleneck, from a dry-run record."""
    cost = record.get("cost_analysis", {})
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = sum(v["bytes"] for v in record.get("collectives", {}).values())

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "dominant": dom.replace("_s", ""),
        "total_flops": flops_dev * n_devices,
        "total_bytes": bytes_dev * n_devices,
        "collective_bytes_per_device": coll_dev,
    }


def model_flops(cfg, shape, n_tokens: int = None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for the step's tokens.

    N counted from the config analytically (embedding excluded, matching
    the convention); D = tokens processed by the step.
    """
    n_active = active_param_count(cfg)
    if n_tokens is None:
        if shape.kind == "train":
            n_tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            n_tokens = shape.global_batch * shape.seq_len
        else:
            n_tokens = shape.global_batch  # one new token per sequence
    mult = 6 if shape.kind == "train" else 2  # fwd+bwd vs fwd
    return float(mult * n_active * n_tokens)


def active_param_count(cfg) -> float:
    """Analytic non-embedding active-parameter count for the config."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    mlp = 3 * d * cfg.d_ff if cfg.d_ff else 0
    moe_active = 3 * d * cfg.expert_ff * cfg.top_k + d * cfg.n_experts if cfg.n_experts else 0
    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * d
        nh = d_inner // cfg.ssm_head_dim
        z = 2 * d_inner + 2 * cfg.ssm_state + nh
        ssm = d * z + d_inner * d
    else:
        ssm = 0
    total = 0.0
    for spec in cfg.layers:
        if spec.kind == "ssm":
            total += ssm
        elif spec.kind == "moe":
            total += attn + moe_active
        else:
            total += attn + mlp
    return total
