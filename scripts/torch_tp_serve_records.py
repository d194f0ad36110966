"""The dry run's tensor-parallel serving records of rank 0, as a table.

    PYTHONPATH=src python scripts/torch_tp_serve_records.py
    PYTHONPATH=src python scripts/torch_tp_serve_records.py --arch zamba2-2.7b \
        --shape decode_32k --mesh multi

Counts each (arch, serving shape) on the meta device as rank 0 of
``repro``'s 16x16 mesh (``--mesh single``, the default) or 2x16x16
(``multi``; the same per-rank numbers): ``launch/dryrun.py::run_one`` in a
one-process fake group.  Prints one markdown row per record: the argument,
temp and peak bytes, the FLOPs and the census a step.  These are counts on
the CPU, not device readings.  By default the MoE, SSM, hybrid and
frontend archs on prefill_32k, decode_32k and long_500k.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b", "mamba2-2.7b", "zamba2-2.7b",
         "internvl2-2b", "musicgen-large")
SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def row(rec) -> str:
    """One markdown row of a serving record."""
    mem = rec["memory_analysis"]
    census = ", ".join(f"{op} {v['bytes']:.4g} B × {v['count']}"
                       for op, v in sorted(rec["collectives"].items())) or "none"
    return (f"| {rec['arch']} | {rec['shape']} | {mem['argument_size_in_bytes']:,} | "
            f"{mem['temp_size_in_bytes']:,} | {rec['peak_bytes'] / 2**30:.3f} | "
            f"{rec['cost_analysis']['flops']:.6g} | {census} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=list(dryrun.ARCH_NAMES))
    ap.add_argument("--shape", action="append", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    args = ap.parse_args(argv)
    print("| arch | shape | argument bytes | temp bytes | peak GiB | FLOPs | census a step |")
    print("|---|---|---|---|---|---|---|")
    for arch in args.arch or ARCHS:
        for shape in args.shape or SHAPES:
            t0 = time.time()
            rec = dryrun.run_one(arch, shape, save=False, verbose=False, mesh=args.mesh)
            assert rec["serve_layout"] == "tensor_parallel", rec["serve_layout"]
            print(row(rec), flush=True)
            print(f"<!-- {arch} {shape} [{rec['mesh']}]: counted in {time.time() - t0:.1f} s "
                  "-->", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
