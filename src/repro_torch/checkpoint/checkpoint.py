"""Atomic, restart-safe checkpointing on the reference's on-disk format
(counterpart of ``repro.checkpoint.checkpoint``): a checkpoint written by
either package restores in the other.

Layout (one directory per step):
    <root>/step_00000120.tmp/      # staged writes
        manifest.json              # step, extra, tree description, arrays
        arrays.npz                 # flat tensors, copied to the host
    <root>/step_00000120/          # atomic rename after fsync

  * atomicity — a checkpoint either fully exists or not at all (tmp dir +
    ``os.replace``);
  * resumability — ``latest_step`` / ``restore`` pick up the newest
    complete checkpoint, and the data pipeline's statelessness makes the
    resumed run bit-identical;
  * integrity — the manifest records each array's crc32, checked on
    restore;
  * retention — ``retain`` keeps the newest N (+ a pinned step).

Keys are the reference's flattened paths: dict keys in sorted order,
tuple and list positions as their index, a NamedTuple's fields as
``.<field>`` (what ``jax.tree_util`` prints for an attribute key) — so
``(params, AdamState)`` flattens to ``0/<param path>``, ``1/.step``,
``1/.m/<param path>`` and ``1/.v/<param path>``.  bfloat16 leaves are
stored upcast to float32 (exactly) and restored to the template's dtype.
The manifest's ``treedef`` is a description for people; restore reads
only the arrays and their checksums.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _paths(tree, prefix: str = ""):
    """Yield (key, leaf) in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), f"{prefix}.{name}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array stored: bfloat16 upcast to float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{n}={_describe(getattr(tree, n))}" for n in tree._fields) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "*"


def save(root: str, step: int, tree: Any, extra: Optional[dict] = None
         ) -> str:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat: Dict[str, np.ndarray] = {k: _to_numpy(v) for k, v in _paths(tree)}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "extra": extra or {},
        "treedef": _describe(tree),
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "crc32": zlib.crc32(v.tobytes()) & 0xFFFFFFFF}
                   for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)           # atomic publish
    return final


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(root, d, "manifest.json"))]
    return max(steps) if steps else None


def _rebuild(template, values: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], values, f"{prefix}{k}/")
                for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _rebuild(getattr(template, n), values, f"{prefix}.{n}/")
            for n in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, values, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return values[prefix[:-1]]


def restore(root: str, template: Any, step: Optional[int] = None,
            verify: bool = True) -> Tuple[Any, dict]:
    """Restore into the structure of ``template`` (shapes must match):
    each leaf a new tensor of the template leaf's dtype on its device."""
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    restored = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for k, tmpl in _paths(template):
            arr = data[k]
            if verify:
                want = manifest["arrays"][k]["crc32"]
                got = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
                if want != got:
                    raise IOError(f"checksum mismatch for {k} in step {step}")
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch {k}: ckpt {arr.shape} vs "
                                 f"template {tuple(tmpl.shape)}")
            restored[k] = torch.from_numpy(np.array(arr)).to(
                device=tmpl.device, dtype=tmpl.dtype)
    return _rebuild(template, restored), manifest


def retain(root: str, keep_last: int = 3,
           pin_step: Optional[int] = None) -> None:
    """Delete all but the newest ``keep_last`` checkpoints (+ pinned)."""
    if not os.path.isdir(root):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(root)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    doomed = steps[:-keep_last] if keep_last else steps
    for s in doomed:
        if pin_step is not None and s == pin_step:
            continue
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)
