"""Some of ``chip_smoke.py``'s phases alone on one H100, in the order named,
after building the four CUDA sources:

    python scripts/torch_phases.py gloo_probe async tp_serve tp_train
    python scripts/torch_phases.py ptxas flash_offset flash_one_seed \
        flash_offset_times tp_serve
    python scripts/torch_phases.py ptxas flash_narrow flash_offset flash_times \
        flash_offset_times
    python scripts/torch_phases.py train_spread

Phases (``PHASES``): ``gloo_probe`` (gloo's all-reduce between two
processes sharing the card: ms a call, a 9 KB and a 9.4 MB bf16 tensor, on
the card, on the host and staged through the host by hand), ``ptxas``
(ptxas's report of the flash kernels of both sources), ``flash_offset`` and
``flash_offset_times`` (phase 3's K5 query-offset checks and times),
``flash_one_seed`` (one seed of ``check_flash``, the launches without an
offset), ``flash_narrow`` (``check_flash``'s bf16 cases at D = 64, 80 and
128, where K5 runs ``fwd_narrow_kernel``, at every seed), ``flash_times`` (phase
3's times: ``time_flash`` at gemma3-1b's full and window-512 layers, then
``time_flash_other_shapes``, D = 80 at zamba2's H = KV = 32 and phase 19's
rank, D = 64 at granite-moe's training shape, D = 128 at internvl2's
prefill and training shape, beside SDPA), ``flash_f32`` (``check_flash``'s
f32 cases, ``TF32_CASES``, at every seed), ``flash_f32_times`` (phase 3's
f32 times, ``time_flash_f32``: D = 64, 80 and 128 and gemma3-1b's full and
window-512 layers at D = 256, beside SDPA in f32), ``train`` (phase 13), ``launch``
(phase 15: the train step of gemma3-1b and internvl2-2b, and of
granite-moe-1b-a400m and gemma3-1b in f32, against the dry run, its
gradient check and planted faults), ``launch_f32`` (phase 15's f32 steps
alone), ``launch_gemma_f32`` (gemma3-1b's f32 step alone), ``train_spread`` (phase 13's
training, then its loss check, planted faults too, on each of
``SPREAD_GROUPS`` groups of four client batches: phase 13 reads the first),
``async`` (phase 9), ``tp_serve`` (phases 18 and 20: one spawn of
two gloo processes) and ``tp_train`` (phase 19).  From ``train`` on,
cuDNN is deterministic, as in ``chip_smoke.py`` from phase 8 on.  Prints
the card's name and power limit first.
"""
import datetime
import subprocess
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


SPREAD_GROUPS = 4


def train_spread():
    for arch in cs.ARCH_TRAIN:
        cfg, trained, _ = cs.arch_train(arch)
        ref_cfg = cfg.replace(kernel_impl="reference")
        n = cs.TRAIN_LOSS_BATCHES
        batches = cs.train_loss_batches(cfg, SPREAD_GROUPS * n)
        for g in range(SPREAD_GROUPS):
            line = cs.train_loss_check(trained, cfg, ref_cfg, batches[g * n:(g + 1) * n],
                                       cs.TRAIN_FAULTS)[-1]
            print(f"train_spread[{arch}] client batches {g * n}-{(g + 1) * n - 1}: {line}",
                  flush=True)
        del trained, batches
    return SPREAD_GROUPS


def _tp_serve():
    cs.l2_flush.cache_clear()
    torch.cuda.empty_cache()
    return cs.tp_serve_run()


# name -> (the phase, whether cuDNN runs deterministic in it)
PHASES = {
    "gloo_probe": (lambda: cs._spawn_two(probe, (), 300), False),
    "ptxas": (lambda: [cs.print_ptxas(src) for src in (cs.flash_ops.SM90_SOURCE,
                                                        cs.flash_ops.SOURCE)], False),
    "flash_offset": (cs.check_flash_offset, False),
    "flash_one_seed": (lambda: cs.check_flash(seeds=(12,)), False),
    "flash_offset_times": (cs.time_flash_offset, False),
    "flash_narrow": (lambda: cs.check_flash(cases=cs.NARROW_CASES), False),
    "flash_times": (lambda: {"gemma3-1b": cs.time_flash(4, 1, 256, (None, 512), seed=13),
                             **cs.time_flash_other_shapes()}, False),
    "flash_f32_times": (cs.time_flash_f32, False),
    "flash_f32": (lambda: cs.check_flash(cases=cs.TF32_CASES), False),
    "train": (lambda: {a: cs.arch_train_run(a) for a in cs.ARCH_TRAIN}, True),
    "launch": (cs.launch_tooling_run, True),
    "launch_f32": (lambda: cs.launch_tooling_run(
        [key for key in cs.LAUNCH_ARCHS if key[1] == "float32"]), True),
    "launch_gemma_f32": (lambda: cs.launch_tooling_run((("gemma3-1b", "float32"),)), True),
    "train_spread": (train_spread, True),
    "async": (cs.async_run, True),
    "tp_serve": (_tp_serve, True),
    "tp_train": (cs.tp_train_run, True),
}


def main(argv=None):
    names = sys.argv[1:] if argv is None else argv
    unknown = [n for n in names if n not in PHASES]
    if not names or unknown:
        raise SystemExit(f"name phases from {tuple(PHASES)}; unknown: {unknown}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cs.kernel_build.build(cs.ops.SOURCE, cs.rms_ops.SOURCE, cs.flash_ops.SOURCE,
                          cs.flash_ops.SM90_SOURCE)
    for mod in (cs.ops, cs.rms_ops, cs.flash_ops):
        mod.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name in names:
        fn, deterministic = PHASES[name]
        torch.backends.cudnn.deterministic = deterministic
        t0 = time.perf_counter()
        print(name, fn(), flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
