"""Probe of the two tensor-core routes for the f32 flash backward on one H100:

    python scripts/torch_tf32_probe.py

Builds ``scripts/tf32_probe.cu`` and times, with CUDA events around one
long launch each (warm, after one launch of the same kernel):

- ``mma_rate``: mma.sync.m16n8k8 tf32 alone, its TF32 FLOP/s;
- ``split_loop_<mode>``: the f32 product's inner loop on mma.sync (three
  TF32 products a fragment pair), its f32-accurate FLOP/s, with each B
  fragment split in registers by cvt.rna.tf32.f32 (``cvt``) or by integer
  rounding (``int``), or read as (hi, lo) pairs split beforehand
  (``presplit``; ``presplit_m32``: each B fragment used by two 16-row
  tiles of A, as a warp of 32 rows would);
- ``prep_<route>``: the copies each streamed 64 x 64 f32 tile costs,
  microseconds a tile a SM: ``wgmma`` (hi, lo and both transposed written
  128-byte swizzled, an async-proxy fence) or ``mma_sync`` (one (hi, lo)
  pair an element, swizzled);
- ``tf32_int_mismatches``: the finite f32 patterns where the integer
  rounding differs from cvt.rna.tf32.f32 (all 2^32 patterns tried).

Then, for one step of the dk/dv pass (K7: a 128-key block against a 64-query
tile at D = 64: four products, 4.19e6 f32 FLOPs, two streamed tiles Q and
dO), the step's time a SM on each route: mma.sync at each measured loop
rate (plus, pre-split, its two tiles' copies), and wgmma's products at the
495e12 FLOP/s data-sheet peak (the least it could take) and at half of it
(``WGMMA_SHARE``: the share of their bound the bf16 wgmma backward kernels
reach, PERF.md), each plus its two tiles' copies.  Prints the card's name
and power limit first and writes the numbers to
``chiprun_out/tf32_probe.json``.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import torch  # noqa: E402

from repro_torch.kernels import build as kb  # noqa: E402

SOURCE = ROOT / "scripts" / "tf32_probe.cu"
SMS = 132
TF32_PEAK = 495e12  # dense TF32 FLOP/s, H100 SXM data sheet
STEP_FLOPS = 4 * 2 * 128 * 64 * 64  # K7: S^T, dP^T, dV, dK of 128 keys x 64 queries x 64
STEP_TILES = 2  # the Q and dO tiles a K7 step streams
LOOPS = ("cvt", "int", "presplit", "presplit_m32")  # split_loop_kernel's modes 0-3
WGMMA_SHARE = 0.5  # the bf16 wgmma dq / dk-dv kernels: 39-53 % of their bound


def timed(fn, blocks, iters):
    """Seconds of one launch of ``fn(out, blocks, iters, stream)`` (after a
    warm-up launch)."""
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(out.data_ptr(), blocks, iters, stream)
        end.record()
        if err:
            raise RuntimeError(f"probe launch failed: cudaError {err}")
        torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    return start.elapsed_time(end) / 1e3


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = ctypes.CDLL(str(kb.build(SOURCE)[0]))
    args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.probe_mma_rate.argtypes = args + [ctypes.c_void_p]
    for name in ("probe_split_loop", "probe_prep"):
        getattr(lib, name).argtypes = args + [ctypes.c_int, ctypes.c_void_p]
    lib.probe_tf32_equal.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    name = None
    for line in kb.build_log(SOURCE).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)

    r = {"card": smi}
    blocks = 4 * SMS
    sec = timed(lambda *a: lib.probe_mma_rate(*a), blocks, 20000)
    r["mma_rate_tf32_flops"] = blocks * 8 * 20000 * 8 * 2048 / sec
    for mode, label in enumerate(LOOPS):
        sec = timed(lambda o, b, i, s: lib.probe_split_loop(o, b, i, mode, s), blocks, 2000)
        r[f"split_loop_{label}_f32_flops"] = (blocks * 8 * 2000 * 64 * 2048 / sec
                                              * (2 if label == "presplit_m32" else 1))
    for mode, label in enumerate(("wgmma", "mma_sync")):
        sec = timed(lambda o, b, i, s: lib.probe_prep(o, b, i, mode, s), 2 * SMS, 5000)
        r[f"prep_{label}_us_per_tile_per_sm"] = 1e6 * sec / (5000 * 2)
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    assert lib.probe_tf32_equal(bad.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    r["tf32_int_mismatches"] = int(bad.item())

    per_sm = lambda rate: rate / SMS  # noqa: E731
    for label in LOOPS:
        us = 1e6 * STEP_FLOPS / per_sm(r[f"split_loop_{label}_f32_flops"])
        if label.startswith("presplit"):
            us += STEP_TILES * r["prep_mma_sync_us_per_tile_per_sm"]
        r[f"k7_step_us_mma_sync_{label}"] = us
    copies = STEP_TILES * r["prep_wgmma_us_per_tile_per_sm"]
    wg = 1e6 * 3 * STEP_FLOPS / per_sm(TF32_PEAK)
    r["k7_step_us_wgmma_at_peak"] = wg + copies
    r["k7_step_us_wgmma_at_half"] = wg / WGMMA_SHARE + copies
    for k, v in r.items():
        print(f"{k}: {v if isinstance(v, str) else f'{v:.6g}'}", flush=True)
    print(f"mma.sync TF32 at {100 * r['mma_rate_tf32_flops'] / TF32_PEAK:.1f}% of wgmma's "
          "data-sheet peak; the f32 loop at " + ", ".join(
              f"{label} {100 * 3 * r[f'split_loop_{label}_f32_flops'] / r['mma_rate_tf32_flops']:.1f}%"
              for label in LOOPS) + " of mma.sync's rate", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "tf32_probe.json").write_text(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
