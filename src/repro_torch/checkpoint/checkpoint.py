"""Checkpoint save and restore with atomic completion, ported from the JAX
package's ``checkpoint/checkpoint.py``, in its layout:

    ckpt_dir/step_000000042.tmp/       # written first
        manifest.json                  # step, time, tree, leaf shapes/dtypes
        arr_00000.npy ... arr_NNNNN.npy
        scheduler.json                 # EWSJF scheduler state (optional)
    ckpt_dir/step_000000042/           # atomic rename when complete

A tree is nested dicts (flattened in sorted key order, as JAX flattens
them), lists and tuples (named tuples too) with tensor or numpy leaves;
``None`` holds no leaf.  A :class:`Stacked` leaf is equal-shaped tensors
saved as one array with a leading axis: the bridge lays a training state
out as the JAX package's tree with its period-stacked layers
(``bridge.train_state_tree``), so a port checkpoint lists the leaves a JAX
checkpoint of the same state lists.  CUDA tensors are saved through
``.cpu()``; bf16 tensors as their 16-bit patterns, named ``bfloat16`` in
the manifest.

Fault tolerance: a crash mid-save leaves a ``.tmp`` directory that
:func:`latest_step` ignores, so a restore reads the newest complete step.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


class Stacked(list):
    """One checkpoint leaf made of equal-shaped tensors stacked on a new
    leading axis (the JAX stack's period axis)."""


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        return [leaf for t in tree for leaf in _flatten(t)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_flatten`'s order, by
    the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        items = [_rebuild(t, leaves) for t in tree]
        if hasattr(tree, "_fields"):                      # a named tuple
            return type(tree)(*items)
        return type(tree)(items)
    return next(leaves)


def _treedef(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        inner = ", ".join(_treedef(t) for t in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    return "*"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to save, dtype name for the manifest)."""
    if isinstance(leaf, Stacked):
        parts = [_to_numpy(t) for t in leaf]
        return np.stack([a for a, _ in parts]), parts[0][1]
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _shape(leaf) -> tuple:
    if isinstance(leaf, Stacked):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(np.shape(leaf))


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """The saved array as ``like``'s kind of leaf; tensor leaves are
    overwritten in place, on their device and in their dtype."""
    if isinstance(like, Stacked):
        for t, a in zip(like, arr):
            _from_numpy(a, dtype, t)
        return like
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        with torch.no_grad():
            like.copy_(t)
        return like
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().astype(np.asarray(like).dtype)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any,
                    scheduler_state: Optional[dict] = None,
                    keep: int = 3) -> Path:
    """Save ``tree`` (and the scheduler's state) as step ``step``; keep the
    newest ``keep`` complete steps.  Returns the step's directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = _flatten(tree)
    manifest = {"step": step, "time": time.time(),
                "treedef": f"PyTreeDef({_treedef(tree)})",
                "n_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / f"arr_{i:05d}.npy", arr)
        manifest["leaves"].append({"i": i, "shape": list(arr.shape),
                                   "dtype": dtype})
    if scheduler_state is not None:
        (tmp / "scheduler.json").write_text(json.dumps(scheduler_state))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic completion marker
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest complete step in ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, tree_like: Any,
                       step: Optional[int] = None):
    """Restore step ``step`` (default the newest) into the structure of
    ``tree_like``.  Tensor leaves (and :class:`Stacked` ones) are
    overwritten in place, each on its device and in its dtype, so a training
    state restores without a second copy on the card; numpy leaves are
    replaced by new arrays.  Raises ``ValueError`` before writing anything
    when the leaf count or a shape differs.  Returns (tree, step, scheduler
    state or None)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = _flatten(tree_like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"leaf count mismatch: {len(leaves)} vs "
                         f"{manifest['n_leaves']}")
    for i, (like, saved) in enumerate(zip(leaves, manifest["leaves"])):
        if _shape(like) != tuple(saved["shape"]):
            raise ValueError(f"leaf {i}: {tuple(saved['shape'])} saved, "
                             f"{_shape(like)} to restore into")
    new = [_from_numpy(np.load(d / f"arr_{i:05d}.npy"), saved["dtype"], like)
           for i, (like, saved) in enumerate(zip(leaves, manifest["leaves"]))]
    sched = None
    if (d / "scheduler.json").exists():
        sched = json.loads((d / "scheduler.json").read_text())
    return _rebuild(tree_like, iter(new)), step, sched


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted([p for p in ckpt_dir.iterdir()
                    if p.is_dir() and p.name.startswith("step_")
                    and not p.name.endswith(".tmp")],
                   key=lambda p: p.name)
    for p in steps[:-keep]:
        shutil.rmtree(p)
