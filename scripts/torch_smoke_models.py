"""Quick dev smoke of the PyTorch port: every reduced arch does a forward +
loss + decode step.

Counterpart of ``scripts/smoke_models.py``: the reduced configs (f32, head
dim 64), so on the card K4 and the f32 K5 (``fwd_tf32_kernel<64>``) run.  Runs on the card unless
given ``--device cpu``.

  PYTHONPATH=src python scripts/torch_smoke_models.py [--device cpu] [arch ...]
"""
import argparse
import math

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import transformer as tf
from repro_torch.utils.device import resolve_device


def make_batch(cfg, dev, b=2, s=32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.frontend == "audio_codebooks":
        toks = torch.randint(0, cfg.vocab_size, (b, cfg.n_codebooks, s), generator=g, device=dev)
        return {"tokens": toks, "labels": toks}
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    if cfg.frontend == "vision_stub":
        pe = torch.randn((b, cfg.n_patches, cfg.d_vision), generator=g, device=dev)
        return {"tokens": toks, "labels": toks, "patch_embeds": pe}
    return {"tokens": toks, "labels": toks}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", help=f"archs to run (default: all of {ARCH_NAMES})")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for name in args.archs or ARCH_NAMES:
        cfg = get_config(name, reduced=True)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        batch = make_batch(cfg, dev)
        with torch.no_grad():
            loss = tf.lm_loss(params, cfg, batch).item()
        assert math.isfinite(loss), f"{name}: loss {loss}"
        # decode one token
        caches = tf.init_caches(cfg, 2, 64, device=dev)
        db = dict(batch)
        if cfg.frontend == "audio_codebooks":
            db["tokens"] = batch["tokens"][:, :, :1]
        elif cfg.frontend == "vision_stub":
            db["tokens"] = batch["tokens"][:, :1]
            db["patch_embeds"] = batch["patch_embeds"][:, :0]
        else:
            db["tokens"] = batch["tokens"][:, :1]
        db.pop("labels", None)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        logits, _ = tf.decode_step(params, cfg, db, pos, caches)
        assert bool(torch.isfinite(logits.float()).all()), name
        print(f"{name:24s} loss={loss:.4f} decode_logits={tuple(logits.shape)} OK", flush=True)


if __name__ == "__main__":
    main()
