"""Calibrated roofline: per-pattern unit costs composed over the depth.

Port of ``repro/launch/calibrate.py`` at one device.  ``repro`` needs the
calibration because XLA's ``cost_analysis()`` counts a ``while`` loop's body
once whatever its trip count; the port's counts come from running the step
on the meta device (``launch/dryrun.py``), which sees every op of every
iteration, so they are exact at any depth.  The method is kept, so the two
packages' records compare term for term:

  count variant A: the pattern unrolled ONCE (tail = pattern, no
                   repetitions), T = 1, attn_q_block = ssm_chunk = seq;
  count variant B: the pattern unrolled TWICE -> unit = B - A;
  compose:  total = T x [ (A - unit) + unit x n_rep + unit/|pattern| x |tail| ]

Because the port's counts are exact, the composition can be checked
(``tests/test_torch_dryrun.py``): at T = 1, with a tail of whole patterns
(or none), the composed FLOPs and launches equal a direct count of the
full-depth config, since each layer's work, the round-start update (N grows
with the layers) and the server mean are linear in the depth.  Not linear
in the depth, or not composed exactly: at T > 1 the once-per-step terms
(the round-start K1/K2 pair, the new delta, the server mean) are multiplied
by T, the overcount ``repro`` documents; a partial tail is costed at the
pattern's mean layer (gemma3-1b's two windowed tail layers against a
pattern with one global layer); the bytes miss the full config's stacked
layout, whose backward stacks each pattern position's layer gradients once
more (the unrolled variants keep one leaf per layer); and peak memory, a
maximum over the step, is not composed (``dryrun.py`` reports it from the
full config).

  PYTHONPATH=src python -m repro_torch.launch.calibrate --arch gemma3-1b --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import steps as st
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "roofline_torch"


def _unrolled_cfg(cfg, shape, n_copies: int, ssm_chunk=None):
    seq = shape.seq_len
    pattern = tuple(cfg.pattern) * n_copies
    chunk = ssm_chunk or seq  # default: single SSD chunk (trip count 1)
    return cfg.replace(
        pattern=(), n_rep=0, tail=pattern,
        n_layers=len(pattern),
        ssm_chunk=chunk,
        # if chunked, unroll the inter-chunk scan so every trip is counted
        ssm_scan_unroll=max(1, seq // chunk),
        attn_q_block=seq,
    )


def _measure(arch, shape, n_copies, variant, micro_batch, ssm_chunk=None):
    """Count one unrolled variant at T = 1 on the meta device."""
    shape = dryrun.resolve_shape(shape)
    ucfg = _unrolled_cfg(get_config(arch), shape, n_copies, ssm_chunk=ssm_chunk)
    step, args, _ = dryrun.build_inputs(arch, shape, micro_batch, variant, t_override=1,
                                        cfg=ucfg)
    _, c = dryrun.count(step, args)
    return {"flops": float(c["flops"]), "bytes": float(c["bytes"]), "launches": c["launches"]}


def calibrate_one(arch, shape, variant="baseline", micro_batch=st.MICRO_BATCH, save=True,
                  verbose=True, ssm_chunk=None, tag_suffix=""):
    """``shape``: a name of ``INPUT_SHAPES`` or an ``InputShape``."""
    cfg = get_config(arch)
    shape = dryrun.resolve_shape(shape)
    rcfg = st.resolve_cfg(cfg, shape)
    t0 = time.time()
    a = _measure(arch, shape, 1, variant, micro_batch, ssm_chunk=ssm_chunk)
    b = _measure(arch, shape, 2, variant, micro_batch, ssm_chunk=ssm_chunk)
    t_cal = time.time() - t0

    n_pat = len(rcfg.pattern)
    reps = rcfg.n_rep
    tail_frac = len(rcfg.tail) / max(1, n_pat)
    if shape.kind == "train":
        mb = min(dryrun.micro_batch_for(cfg, micro_batch), shape.global_batch)
        t_iters = max(1, shape.global_batch // mb)
    else:
        t_iters = 1

    def compose(ka, kb):
        unit = kb - ka
        fixed = ka - unit
        return t_iters * (fixed + unit * (reps + tail_frac))

    flops_dev = compose(a["flops"], b["flops"])
    bytes_dev = compose(a["bytes"], b["bytes"])
    coll_dev = 0.0  # one device: no collective
    launches = {k: compose(a["launches"].get(k, 0), b["launches"].get(k, 0))
                for k in sorted(set(a["launches"]) | set(b["launches"]))}

    n_dev = 1
    record = {
        "arch": arch, "shape": shape.name, "mesh": "1", "variant": variant,
        "method": "two-point unit calibration (see launch/calibrate.py)",
        "t_iters": t_iters, "n_rep": reps, "pattern_len": n_pat,
        "unit_flops_per_pattern": b["flops"] - a["flops"],
        "fixed_flops": 2 * a["flops"] - b["flops"],
        "per_device": {"flops": flops_dev, "bytes": bytes_dev,
                       "collective_bytes": coll_dev},
        "launches": launches,
        "roofline": {
            "compute_s": flops_dev / PEAK_FLOPS,
            "memory_s": bytes_dev / HBM_BW,
            "collective_s": coll_dev / NVLINK_BW,
        },
        "total_flops": flops_dev * n_dev,
        "total_bytes": bytes_dev * n_dev,
        "calibrate_s": round(t_cal, 1),
    }
    terms = record["roofline"]
    record["roofline"]["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]
    ).replace("_s", "")

    if verbose:
        print(f"== {arch} x {shape.name} ({variant}) calibrated in {t_cal:.0f}s ==")
        print("   roofline: " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record["roofline"].items()))
        print(f"   launches: {launches}")
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape.name}__1"
        if variant != "baseline":
            tag += f"__{variant}"
        if tag_suffix:
            tag += f"__{tag_suffix}"
        (ART_DIR / f"{tag}.json").write_text(json.dumps(record, indent=1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--tag-suffix", default="")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    failures = []
    for arch in archs:
        for shape in shapes:
            try:
                calibrate_one(arch, shape, variant=args.variant, ssm_chunk=args.ssm_chunk,
                              tag_suffix=args.tag_suffix)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                print(f"!! FAIL {arch} x {shape}: {e}")
                traceback.print_exc()
    if failures:
        print(f"{len(failures)} failures: {failures}")
        raise SystemExit(1)
    print("CALIBRATION COMPLETE")


if __name__ == "__main__":
    main()
