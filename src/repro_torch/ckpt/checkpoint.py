"""Sharded, atomic, async-capable checkpointing, on the reference's
on-disk layout:

    <dir>/step_<k>/
        manifest.json      — n_leaves, shard names, dtypes, shapes, step
        shard_<i>.npz      — leaves ``leaf_<j>``, 64 per shard
    <dir>/LATEST           — committed pointer (atomic rename)

Leaves are listed in the order ``jax.tree.flatten`` gives the same tree
(sorted dict keys, NamedTuple fields in order, ``None`` holding none:
:func:`repro_torch.utils.tree.tree_leaves`), and bf16 leaves are stored
as their raw bytes (``uint8``) with ``"bfloat16"`` in the manifest, as the
reference stores them.  So a checkpoint written by the JAX package's
``Trainer`` restores into the port's, and the other way round.

Guarantees:
  * step-atomic: the LATEST pointer is renamed only after every shard and
    the manifest are fully on disk — a crash mid-write never corrupts the
    restore path;
  * async: :class:`AsyncCheckpointer` copies the tree to the host, then
    writes it on a background thread while training goes on.

A run on a mesh (``train.loop.Trainer`` with one, pipeline or GSPMD)
writes the global layout: rank 0 saves the gathered state, and every
rank restores it and takes its own blocks — :func:`restore`'s
``shardings`` (a tree of ``dist.sharding.NamedSharding``), the
reference's elastic re-sharding.  So one checkpoint moves between
mesh-less, pipeline and GSPMD runs, on any mesh shape.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

_LEAVES_PER_SHARD = 64


def _to_numpy(x) -> Tuple[np.ndarray, str, list]:
    """(the array to store, its dtype name and shape for the manifest)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            raw = x.view(torch.int16).numpy().reshape(-1).view(np.uint8)
            return raw, "bfloat16", list(x.shape)
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype), list(x.shape)


def _from_numpy(arr: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        raw = np.ascontiguousarray(arr).view(np.int16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"restore: a leaf stored as {arr.dtype} where the "
                         f"manifest says {dtype}")
    return torch.from_numpy(np.array(arr))


def save(directory: str, step: int, tree) -> str:
    """Blocking sharded save + atomic commit; returns the step dir."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    packed = [_to_numpy(x) for x in tree_leaves(tree)]
    host = [arr for arr, _, _ in packed]
    manifest = {
        "step": step,
        "n_leaves": len(host),
        "shards": [],
        "dtypes": [dtype for _, dtype, _ in packed],
        "shapes": [shape for _, _, shape in packed],
    }
    for si in range(0, len(host), _LEAVES_PER_SHARD):
        chunk = host[si: si + _LEAVES_PER_SHARD]
        name = f"shard_{si // _LEAVES_PER_SHARD:05d}.npz"
        np.savez(os.path.join(tmp_dir, name),
                 **{f"leaf_{si + j}": c for j, c in enumerate(chunk)})
        manifest["shards"].append(name)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)  # atomic on POSIX

    # commit the LATEST pointer last
    fd, tmp = tempfile.mkstemp(dir=directory)
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(tmp, os.path.join(directory, "LATEST"))
    return step_dir


def _host_copy(x):
    """A host copy of a leaf that later in-place updates cannot touch."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class AsyncCheckpointer:
    """One in-flight save at a time; wait() joins the previous write."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, directory: str, step: int, tree) -> None:
        self.wait()
        host_tree = tree_map(_host_copy, tree)  # snapshot before async
        self._thread = threading.Thread(
            target=save, args=(directory, step, host_tree), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    pointer = os.path.join(directory, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[-1])


def restore(directory: str, like_tree, step: Optional[int] = None,
            shardings=None) -> Tuple[object, int]:
    """Restore into the structure of ``like_tree`` (global shapes) as CPU
    tensors; a leaf count or a leaf shape that differs from
    ``like_tree``'s raises ``ValueError``.  ``shardings`` (a matching
    tree of ``dist.sharding.NamedSharding``) re-shards: each leaf becomes
    this rank's block on its mesh's device — the elastic-resize path
    (the mesh may differ from the saving run's)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves: Dict[int, np.ndarray] = {}
    for name in manifest["shards"]:
        with np.load(os.path.join(step_dir, name)) as z:
            for key in z.files:
                leaves[int(key.split("_")[1])] = z[key]
    like = tree_leaves(like_tree)
    if manifest["n_leaves"] != len(like):
        raise ValueError(f"restore: the checkpoint at {step_dir} has "
                         f"{manifest['n_leaves']} leaves, the tree "
                         f"{len(like)}")
    flat = []
    for i, want in enumerate(like):
        shape = tuple(manifest["shapes"][i])
        if shape != tuple(np.shape(want)):
            raise ValueError(f"restore: leaf {i} has shape {shape} in "
                             f"{step_dir}, the tree wants "
                             f"{tuple(np.shape(want))}")
        flat.append(_from_numpy(leaves[i], manifest["dtypes"][i], shape))
    tree = tree_unflatten(like_tree, flat)
    if shardings is not None:
        tree = tree_map(lambda x, s: s.shard(x), tree, shardings)
    return tree, step
