"""A/B of a flash source on one H100: the working source beside other copies
of it (another commit's, or an edited one), each built into a library of
its own, in one run:

    python scripts/torch_flash_ab.py parent=build/ab/parent.cu \\
        no_drain=build/ab/no_drain.cu
    python scripts/torch_flash_ab.py --f32 parent=build/ab/parent_f32.cu --seeds 12 21

Without ``--f32`` the source is the tensor-core one (``flash_gqa_sm90.cu``,
bf16); with it, ``flash_gqa.cu`` (f32: the tensor-core K5, K6 and K7 at
head_dim 64, 80 and 128, K6 and K7 at 256 too).  For each source: ptxas's
registers and spills of the forward, dq and dk/dv kernels (and any note
that it serialized their
wgmma products); then, each library in a process of its own swapped in for
the wrappers' (``ops._sm90_lib``, or ``ops._lib`` with ``--f32``), the
source's cases of ``chip_smoke.FLASH_CASES`` at the ``--seeds`` (bf16 at D =
128, or every f32 case, ``chip_smoke.TF32_CASES``: ``check_flash``, unless
``--no-check``) and the device times (``chip_smoke.device_ms``) of K5, K6,
K7 (in bf16 with and without its sum pass, and the sum pass) and K6 + K7 at
``SHAPES`` (with ``--f32`` ``F32_SHAPES``: gemma3-1b's full and window-512
layers at D = 256 too), beside SDPA's forward and backward once at each
full layer (in f32 SDPA in f32 on efficient attention, ``chip_smoke._sdpa``).  Prints the card's name and
power limit first and writes every time to ``chiprun_out/flash_ab.json``
(``flash_ab_f32.json`` with ``--f32``).  A source that does not build fails
the run; one whose check fails or times out is reported and the others go
on.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# (H, KV, D, B, S, window): internvl2-2b's training shape, granite-moe's, zamba2's
SHAPES = {"d128_train": (16, 8, 128, 2, 2048, None), "d64": (16, 8, 64, 2, 2048, None),
          "d80": (32, 32, 80, 2, 2048, None)}
# with --f32 also gemma3-1b's full and window-512 layers (D = 256, G = 4)
F32_SHAPES = {**SHAPES, "d256": (4, 1, 256, 2, 2048, None), "d256_w512": (4, 1, 256, 2, 2048, 512)}
CHILD_S = 600  # one source's check and times, then its process is killed


def ptxas(cs, src):
    """ptxas's lines for the forward, dq and dk/dv kernels of ``src``'s library."""
    from repro_torch.kernels import build as kb

    name = None
    for line in kb.build_log(src).splitlines():
        m = re.search(r"Compiling entry function '(\w+_kernel\w*)'", line)
        if m:
            name = cs._kernel_name(m.group(1))
        elif "serialized" in line:
            print(f"  ptxas note: {line.strip()}", flush=True)
        elif name and re.match(r"(fwd|dq|dkv)_", name) and ("registers" in line or "spill" in line):
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)


def times(label, src, check, f32, seeds):
    """In a child process: ``src``'s library in the wrappers' place, its
    check and times; prints one ``RESULT`` line."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.flash_gqa import ops as fo

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.float32 if f32 else torch.bfloat16
    if f32:
        lib = kb.bind(Path(src), fo.SIGNATURES)
        fo._lib = lambda: lib
        cases = cs.TF32_CASES
    else:
        lib = kb.bind(Path(src), fo.SM90_SIGNATURES)
        fo._sm90_lib = lambda: lib
        cases = [c for c in cs.FLASH_CASES if c[3] == dtype and c[5] == 128]
    if check:
        print(f"[{label}] check: {cs.check_flash(seeds=seeds, cases=cases)}", flush=True)
    out = {}
    for key, (h, kv, d, b, s, window) in (F32_SHAPES if f32 else SHAPES).items():
        g = torch.Generator(device="cuda").manual_seed(18)
        q, k, v, do = cs._attention(g, h, kv, dtype, b=b, s=s, d=d)
        w = dict(window=window)
        o, lse = fo.flash_fwd(q, k, v, **w)
        delta = fo.row_delta(do, o)
        r = {"fwd": cs.device_ms(lambda: fo.flash_fwd(q, k, v, **w)),
             "dq": cs.device_ms(lambda: fo.flash_bwd_dq(q, k, v, do, lse, delta, **w)),
             "dkv": cs.device_ms(lambda: fo.flash_bwd_dkv(q, k, v, do, lse, delta, **w)),
             "pair": cs.device_ms(lambda: (fo.flash_bwd_dq(q, k, v, do, lse, delta, **w),
                                           fo.flash_bwd_dkv(q, k, v, do, lse, delta, **w)))}
        if h > kv and not f32:
            pk, pv = fo.flash_bwd_dkv_partials(q, k, v, do, lse, delta)
            r["dkv_alone"] = cs.device_ms(
                lambda: fo.flash_bwd_dkv_partials(q, k, v, do, lse, delta))
            r["sum"] = cs.device_ms(lambda: fo.flash_bwd_dkv_sum(pk, pv, kv))
        if label == "this" and window is None:
            qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
            sdpa, kt, vt, _ = cs._sdpa(kt, vt, h, dtype)
            r["sdpa_fwd"] = cs.device_ms(lambda: sdpa(qt, kt, vt))
            leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            o2 = sdpa(*leaves)
            r["sdpa_bwd"] = cs.device_ms(
                lambda: torch.autograd.grad(o2, leaves, dot, retain_graph=True))
        out[key] = r
        print(f"[{label}] {key}: " + ", ".join(f"{n} {x:.4f}" for n, x in r.items()),
              flush=True)
    print("RESULT " + json.dumps({label: out}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="label=path of another copy of the source")
    ap.add_argument("--f32", action="store_true", help="flash_gqa.cu and f32 operands")
    ap.add_argument("--seeds", type=int, nargs="+", default=[12])
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return times(*args.child, not args.no_check, args.f32, tuple(args.seeds))
    import chip_smoke as cs
    from repro_torch.kernels import build as kb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    srcs = {"this": cs.flash_ops.SOURCE if args.f32 else cs.flash_ops.SM90_SOURCE}
    for item in args.sources:
        label, path = item.split("=", 1)
        srcs[label] = Path(path).resolve()
    t0 = time.perf_counter()
    kb.build(*dict.fromkeys(srcs.values()))
    print(f"built {len(srcs)} sources in {time.perf_counter() - t0:.1f}s", flush=True)
    results = {}
    for label, src in srcs.items():
        print(f"[{label}] {src}", flush=True)
        ptxas(cs, src)
        cmd = [sys.executable, __file__, "--child", label, str(src), "--seeds",
               *map(str, args.seeds)]
        cmd += ["--no-check"] if args.no_check else []
        cmd += ["--f32"] if args.f32 else []
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=CHILD_S)
            lines = (p.stdout + p.stderr).splitlines() + [f"[{label}] exit {p.returncode}"]
        except subprocess.TimeoutExpired:
            lines = [f"[{label}] timed out after {CHILD_S} s"]
        for line in lines:
            if line.startswith("RESULT "):
                results.update(json.loads(line[len("RESULT "):]))
            elif ("seed=" not in line or args.f32) and "sum pass" not in line:
                print(line, flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    name = "flash_ab_f32.json" if args.f32 else "flash_ab.json"
    (ROOT / "chiprun_out" / name).write_text(json.dumps(results, indent=1))
    return 0 if len(results) == len(srcs) else 1


if __name__ == "__main__":
    sys.exit(main())
