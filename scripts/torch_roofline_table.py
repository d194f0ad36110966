"""Build the roofline markdown table from the PyTorch port's dry-run records.

Counterpart of ``scripts/roofline_table.py`` over ``experiments/dryrun_torch``
(``python -m repro_torch.launch.dryrun``) or, with ``--calibrated``,
``experiments/roofline_torch`` (``python -m repro_torch.launch.calibrate``).
Adds MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference) and the
usefulness ratio MODEL_FLOPS / counted FLOPs (catches remat and dense-MoE
waste).  HBM GB is the step's peak device memory, argument + temp bytes (the
port's temp is the peak of the live storages less the arguments, so it holds
the outputs already).  Times are the H100's roofline terms, not readings.

  PYTHONPATH=src python scripts/torch_roofline_table.py [--calibrated] [--md out.md]
"""
import argparse
import json
from pathlib import Path

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.launch.roofline import model_flops
from repro_torch.launch.steps import resolve_cfg

ROOT = Path(__file__).resolve().parents[1] / "experiments"
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh="1", variant="baseline", calibrated=False, art_dir=None):
    art = Path(art_dir) if art_dir else (ROOT / ("roofline_torch" if calibrated
                                                 else "dryrun_torch"))
    rows = []
    for arch in ARCH_NAMES:
        for shape in SHAPE_ORDER:
            tag = f"{arch}__{shape}__{mesh}"
            if variant != "baseline":
                tag += f"__{variant}"
            f = art / f"{tag}.json"
            if not f.exists():
                continue
            r = json.loads(f.read_text())
            cfg = resolve_cfg(get_config(arch), INPUT_SHAPES[shape])
            mf = model_flops(cfg, INPUT_SHAPES[shape])
            rl = r["roofline"]
            tot = r.get("total_flops", rl.get("total_flops", 0.0))
            if "memory_analysis" in r:
                hbm_gb = (r["memory_analysis"]["argument_size_in_bytes"]
                          + r["memory_analysis"]["temp_size_in_bytes"]) / 1e9
            else:
                hbm_gb = float("nan")
            rows.append({
                "arch": arch, "shape": shape, "mesh": mesh,
                "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
                "collective_s": rl["collective_s"], "dominant": rl["dominant"],
                "model_flops": mf, "counted_flops": tot,
                "useful_ratio": mf / tot if tot else 0.0, "hbm_gb": hbm_gb,
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="1")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--calibrated", action="store_true")
    ap.add_argument("--art-dir", default=None)
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)

    rows = load(args.mesh, args.variant, calibrated=args.calibrated, art_dir=args.art_dir)
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "MODEL_FLOPS | counted FLOPs | useful | HBM GB |")
    lines = [hdr, "|" + "---|" * 10]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['dominant']} | "
            f"{r['model_flops']:.3e} | {r['counted_flops']:.3e} | "
            f"{r['useful_ratio']:.2f} | {r['hbm_gb']:.1f} |")
    table = "\n".join(lines)
    print(table)
    tr = [r for r in rows if r["shape"] == "train_4k"]
    worst = sorted(tr, key=lambda r: r["useful_ratio"])[:3]
    print("\n-- candidates --")
    print("worst useful ratio:", [(r["arch"], r["shape"], round(r["useful_ratio"], 2))
                                  for r in worst])
    if args.md:
        Path(args.md).write_text(table + "\n")
    return rows


if __name__ == "__main__":
    main()
