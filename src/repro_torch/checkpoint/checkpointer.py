"""Checkpoints in the reference's layout (the port's
``repro.checkpoint.checkpointer``), so that either package restores what
the other wrote.

Layout (one directory per step)::

    <dir>/step_00000123/
        manifest.json        # step, time, extra, and each key's shape and dtype
        shard_p0000.npz      # flat key -> array
        COMMITTED            # written last; restore ignores uncommitted dirs

A flat key is the ``/``-joined path of dict keys (``params/blocks/attn/wq``,
``opt/step``), as the reference's ``tree_flatten_with_path`` names a dict
tree.  Leaves are tensors (copied to the host when ``save`` is called) or
numpy arrays; a bf16 tensor has no numpy dtype and is refused.

  * the save copies to host memory synchronously and writes on a
    background thread; ``wait()`` joins it (the next save, a restore and
    shutdown wait first);
  * the shard, the manifest and the marker are fsynced before the rename
    publishes the step (``util/atomic.py``), so a crash never leaves a
    committed-looking step with torn payloads;
  * ``keep`` newest committed steps survive each save (0 keeps all).

On a rank mesh (``mesh=`` and the tree's ``specs=``) the save gathers
every leaf's full tensor, one leaf at a time, and rank 0 writes the same
layout; the restore gives each rank its slice of every leaf, so a step
written on one mesh restores on another (or on one card), as the
reference's ``restore(..., shardings=)`` does.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.util.atomic import atomic_write_json, atomic_write_text, fsync_dir


def _paths(tree, prefix: str = ""):
    """``(key, leaf)`` of a nested dict, keys sorted at every level."""

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("a bf16 tensor has no numpy dtype; checkpoint fp32 masters")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _leaf_shape(leaf) -> tuple:
    """The shape of a ``tree_like`` leaf: a tensor, an array or a
    ``(shape, dtype)`` pair."""

    if isinstance(leaf, tuple) and len(leaf) == 2 and not isinstance(leaf[0], int):
        return tuple(leaf[0])
    return tuple(leaf.shape)


def _unflatten(tree_like, flat: dict[str, np.ndarray], prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in tree_like.items()}
    key = prefix[:-1]
    arr = flat[key]
    if tuple(arr.shape) != _leaf_shape(tree_like):
        raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs "
                         f"{_leaf_shape(tree_like)}")
    return arr


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None, mesh=None,
             specs=None):
        """Snapshot to host memory synchronously, write asynchronously.
        On a rank mesh every rank gathers each leaf whole (``specs``: the
        tree's spec tree) and rank 0 writes."""

        if mesh is not None:
            flat = _gathered(tree, specs, mesh)
            if mesh.rank != 0:
                return
        else:
            flat = _flatten(tree)  # the device->host copy happens here, on purpose
        manifest = {
            "step": int(step),
            "time": time.time(),
            "extra": extra or {},
            "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()},
        }
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, manifest), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, flat, manifest)

    def _write(self, step: int, flat, manifest):
        d = os.path.join(self.dir, f"step_{step:08d}")
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shard = os.path.join(tmp, "shard_p0000.npz")
        np.savez(shard, **flat)
        with open(shard, "rb") as f:
            os.fsync(f.fileno())
        atomic_write_json(os.path.join(tmp, "manifest.json"), manifest,
                          indent=None, sort_keys=False, newline=False)
        atomic_write_text(os.path.join(tmp, "COMMITTED"), "ok")
        fsync_dir(tmp)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        fsync_dir(self.dir)
        self._gc()

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore --------------------------------------------------------------

    def committed_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            suffix = name[len("step_"):] if name.startswith("step_") else ""
            # `.tmp` staging dirs (interrupted saves) already hold COMMITTED
            # before the rename: only fully renamed step dirs count.
            if not suffix.isdigit():
                continue
            if os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, *, step: Optional[int] = None, device=None, mesh=None,
                specs=None):
        """``(tree, manifest)``: the step's arrays in the structure of
        ``tree_like`` (nested dicts of tensors, arrays or ``(shape, dtype)``
        pairs; every shape checked), as tensors on ``device``, or numpy
        arrays with ``device=None``.  ``step=None`` reads the newest
        committed step.  On a rank mesh ``tree_like`` holds this rank's
        shapes and each leaf comes back as its slice under ``specs``
        (after every rank has reached the restore: rank 0's write is
        done)."""

        self.wait()
        if mesh is not None:
            mesh.barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        flat: dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    flat.update({k: z[k] for k in z.files})
        if mesh is not None:
            tree = _sliced(tree_like, flat, specs, mesh)
        else:
            tree = _unflatten(tree_like, flat)
        if device is not None:
            tree = _to_device(tree, device)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return tree, manifest


def _gathered(tree, specs, mesh) -> dict:
    """``_flatten`` of the full tensors of a sharded tree: each leaf
    gathered whole on every rank, kept on the host by rank 0 only."""

    from repro_torch.distributed import spmd

    out = {}
    for (key, leaf), (_, spec) in zip(_paths(tree), _paths(specs)):
        full = spmd.gather_full(leaf, spec, mesh)
        if mesh.rank == 0:
            out[key] = _to_numpy(full)
        del full
    return out


def _sliced(tree_like, flat, specs, mesh, prefix: str = ""):
    """``_unflatten`` for a rank: each leaf checked against the full shape
    of ``tree_like``'s shard, then cut to it."""

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd

    if isinstance(tree_like, dict):
        return {k: _sliced(v, flat, specs[k], mesh, f"{prefix}{k}/") for k, v in tree_like.items()}
    key = prefix[:-1]
    arr = flat[key]
    want = spmd.global_shape(_leaf_shape(tree_like), specs, mesh)
    if tuple(arr.shape) != tuple(want):
        raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs {want}")
    return np.array(SH.local_slice(arr, specs, mesh))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree).reshape(tree.shape)).to(device)


__all__ = ["Checkpointer"]
