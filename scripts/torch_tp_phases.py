"""``chip_smoke.py``'s phases 9, 18 and 19 alone on one H100, after a probe
of gloo's all-reduce between two processes sharing the card (ms a call, a
9 KB and a 9.4 MB bf16 tensor, on the card, on the host and staged through
the host by hand).

    python scripts/torch_tp_phases.py
"""
import datetime
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def probe(rank, port, answers):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    out = {}
    for label, n, iters in (("9 KB", 4 * 1152, 200), ("9.4 MB", 2 * 2048 * 1152, 20)):
        for where in ("cuda", "cpu", "staged"):
            x = torch.ones(n, dtype=torch.bfloat16, device="cpu" if where == "cpu" else "cuda")
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                if where == "staged":
                    y = x.cpu()
                    dist.all_reduce(y)
                    x.copy_(y)
                else:
                    dist.all_reduce(x)
                x.fill_(1)
            torch.cuda.synchronize()
            out[label, where] = 1e3 * (time.perf_counter() - t0) / iters
    dist.destroy_process_group()
    answers.put((rank, True, out))


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cs.kernel_build.build(cs.ops.SOURCE, cs.rms_ops.SOURCE, cs.flash_ops.SOURCE,
                          cs.flash_ops.SM90_SOURCE)
    for mod in (cs.ops, cs.rms_ops, cs.flash_ops):
        mod.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    print("gloo probe (ms an all-reduce):", cs._spawn_two(probe, (), 300), flush=True)
    print(f"probe: {time.perf_counter() - t0:.1f}s", flush=True)
    torch.backends.cudnn.deterministic = True  # as chip_smoke.py from phase 8 on
    for fn in (cs.async_run, cs.tp_serve_run, cs.tp_train_run):
        t0 = time.perf_counter()
        fn()
        print(f"{fn.__name__}: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
