"""Checkpointing: tree save/restore with a JSON manifest.

Port of ``repro/utils/checkpoint.py``, with its on-disk layout:

    <dir>/step_<N>/arrays.npz + manifest.json

The manifest records each leaf's path name (dict key, sequence index or
NamedTuple field, joined with "/") and dtype; restore rebuilds the tree
against a template of the same structure.  Tensors leave through numpy: a
bf16 tensor is stored as its int16 bit pattern (numpy has no bfloat16)
under the dtype name ``bfloat16``, and comes back bit for bit, on the
template leaf's device.  Numpy leaves (RNG words, histories, scheduler
arrays) stay numpy.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_flatten, tree_flatten_with_path, tree_unflatten


def flatten_with_names(tree):
    return [("/".join(str(k) for _, k in path), leaf)
            for path, leaf in tree_flatten_with_path(tree)]


def leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(ckpt_dir, step: int, tree: Any, extra: Optional[dict] = None):
    d = Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    named = flatten_with_names(tree)
    arrays = {f"a{i}": leaf_to_numpy(leaf) for i, (_, leaf) in enumerate(named)}
    np.savez(d / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "names": [n for n, _ in named],
        "dtypes": [_dtype_name(leaf) for _, leaf in named],
        "extra": extra or {},
    }
    (d / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return str(d)


def read_manifest(ckpt_dir, step: Optional[int] = None) -> dict:
    """A checkpoint's manifest, without its arrays.  The async driver's tree
    has subtrees whose presence is recorded in ``extra`` (in-flight work,
    the aggregation buffer), so its restore template is built after this."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text())


def rng_state_tree(rng: np.random.RandomState) -> dict:
    """A host RandomState's MT19937 state as numpy arrays (npz round-trips
    them exactly), so a restored federation resumes its sampling stream."""
    kind, keys, pos, has_gauss, cached = rng.get_state()
    if kind != "MT19937":
        raise ValueError(f"unsupported bit generator {kind!r} (expected MT19937)")
    return {
        "keys": np.asarray(keys, np.uint32),
        "pos": np.asarray(pos, np.int64),
        "has_gauss": np.asarray(has_gauss, np.int64),
        "cached_gaussian": np.asarray(cached, np.float64),
    }


def restore_rng_state(rng: np.random.RandomState, tree: dict) -> None:
    """Inverse of ``rng_state_tree``."""
    rng.set_state((
        "MT19937",
        np.asarray(tree["keys"], np.uint32),
        int(tree["pos"]),
        int(tree["has_gauss"]),
        float(tree["cached_gaussian"]),
    ))


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def leaf_like(arr: np.ndarray, leaf):
    """``arr`` as the template ``leaf``'s kind: a tensor of its dtype on its
    device, a numpy array of its dtype, or the raw array."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if leaf.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.array(arr, dtype=leaf.dtype)
    return arr


def load_checkpoint(ckpt_dir, template: Any, step: Optional[int] = None):
    """Restore into the structure of ``template``.  Returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / "arrays.npz")
    named_t = flatten_with_names(template)
    if [n for n, _ in named_t] != manifest["names"]:
        raise ValueError(f"checkpoint at {d} holds leaves {manifest['names']}, "
                         f"the template {[n for n, _ in named_t]}")
    by_name = {n: data[f"a{i}"] for i, n in enumerate(manifest["names"])}
    leaves = [leaf_like(by_name[n], leaf) for n, leaf in named_t]
    _, treedef = tree_flatten(template)
    return tree_unflatten(treedef, leaves), manifest["extra"]
