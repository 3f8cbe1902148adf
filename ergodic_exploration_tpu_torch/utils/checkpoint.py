"""Checkpoint / resume for long batched exploration runs (port of
``ergodic_exploration_tpu/utils/checkpoint.py``, in the same file format, so
that a file either package wrote loads in the other).

Format (version 2): a flat ``.npz`` with one ``leaf_%04d`` entry per leaf plus
a ``__meta__`` JSON record carrying the format version and the path-based
leaf keys, shapes and dtypes. The keys are the strings
``jax.tree_util.keystr`` gives for the tree's paths (``.state.U``,
``.state.buffer.states``, ... for NamedTuple fields, ``[0]`` for sequence
items, ``['k']`` for dict entries), produced here without JAX. Loading
validates version, keys and shapes against the ``like`` template and fails
loudly on any mismatch, so a reordered or renamed field can never silently
load wrong data into a same-shape leaf.

On a mesh the engine gathers the state over the ``scenario`` group first and
every rank calls :func:`save_pytree` with ``collective=True``: world rank 0
writes, and no rank returns before the file is whole.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed

CHECKPOINT_FORMAT_VERSION = 2


def _flatten(tree, prefix=""):
    """[(key, leaf)] in JAX's pytree order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kl for f in tree._fields for kl in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kl for i, v in enumerate(tree) for kl in _flatten(v, f"{prefix}[{i}]")]
    if isinstance(tree, dict):
        return [kl for k in sorted(tree) for kl in _flatten(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced from the iterator."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_pytree(path: str, tree, collective: bool = False) -> None:
    """Save a tree (NamedTuples, sequences, dicts) of tensors or arrays to
    ``path`` (.npz, format v2). ``collective``: every rank of the process
    group calls it with the same (gathered) tree; world rank 0 writes, and a
    barrier then holds every rank until the file is whole."""
    flat = _flatten(tree)
    arrays = {f"leaf_{i:04d}": _numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    meta = {
        "version": CHECKPOINT_FORMAT_VERSION,
        "keys": [k for k, _ in flat],
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
    }
    if not collective or torch.distributed.get_rank() == 0:
        np.savez(path, __meta__=np.array(json.dumps(meta)), **arrays)
    if collective:
        torch.distributed.barrier()


def load_pytree(path: str, like):
    """Load a tree saved by :func:`save_pytree` (of either package).

    ``like`` supplies the structure: the file's leaf keys and shapes must
    match it exactly and the format version must be supported, else
    ``ValueError``. Leaves come back as tensors of the template leaf's dtype
    on its device (numpy arrays for numpy template leaves)."""
    flat = _flatten(like)
    keys = [k for k, _ in flat]
    with np.load(path) as data:
        if "__meta__" not in data.files:
            raise ValueError(f"{path} has no __meta__ record: not a format version "
                             f"{CHECKPOINT_FORMAT_VERSION} checkpoint")
        meta = json.loads(str(data["__meta__"]))
        version = meta.get("version")
        if version is None or version > CHECKPOINT_FORMAT_VERSION:
            raise ValueError(f"checkpoint format version {version!r} is newer than "
                             f"supported ({CHECKPOINT_FORMAT_VERSION})")
        if meta["keys"] != keys:
            missing = [k for k in keys if k not in meta["keys"]]
            extra = [k for k in meta["keys"] if k not in keys]
            raise ValueError(
                "checkpoint leaf keys do not match the template pytree "
                f"(missing from file: {missing or 'none'}; unexpected in file: "
                f"{extra or 'none'}; full file order: {meta['keys']})")
        leaves = [data[f"leaf_{i:04d}"] for i in range(len(keys))]
        leaves = [np.asarray(a) for a in leaves]
    out = []
    for (key, tmpl), got in zip(flat, leaves):
        if got.shape != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape {got.shape} but template "
                             f"expects {tuple(tmpl.shape)}")
        if isinstance(tmpl, torch.Tensor):
            # uint32 key words do not convert to torch directly: widen first
            wide = got.astype(np.int64) if got.dtype == np.uint32 else got
            out.append(torch.as_tensor(wide, device=tmpl.device).to(tmpl.dtype))
        else:
            out.append(np.asarray(got, dtype=np.asarray(tmpl).dtype))
    return _unflatten(like, iter(out))
