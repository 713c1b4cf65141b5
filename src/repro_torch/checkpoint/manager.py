"""Step-atomic sharded checkpoints with async save and restart from the
latest (counterpart of ``repro/checkpoint/manager.py``, same layout).

One directory per step:

    <root>/step_000000123/
        manifest.json       — each leaf's path, shape and dtypes (or its
                              value, for a leaf that is not a tensor), the
                              shard that holds it, and the caller's extra
                              metadata (data-pipeline state, serving
                              bookkeeping)
        shard_00000.npz     — the tensors, flat (a shard closes once it
        ...                   holds ``shard_bytes``)
        COMMITTED           — written last; a step without it is garbage

Crash safety: a step is written under ``step_X.tmp`` and renamed into place
after ``COMMITTED`` lands, so a save cut short never spoils the latest good
step, and ``restore_latest`` skips uncommitted directories.

A tree is a nest of dicts, lists, tuples and NamedTuples
(``models.common.tree_leaves_with_path``). Its tensors go to numpy; bf16,
which numpy lacks, is written as its bits in ``uint16`` with the torch
dtype in the manifest. A leaf that is not a tensor (``DecodeState.prng``,
an int; None) is kept in the manifest as its JSON value.

``save`` copies every tensor to host memory before it returns, so the
caller may go on writing its tensors in place (the serving engine's page
pools change every tick): with ``async_save`` only the file writes run in a
background thread, one save deep (the next ``save`` or ``wait`` joins it).
``restore(step, like)`` checks each leaf's path, shape and dtype against
``like`` and puts each tensor on the device of ``like``'s leaf.

A tree placed on a training mesh (``sharding/training.py``: ``DataShards``
leaves) is saved as its whole tensors, JAX's layout of global arrays, so
the files do not depend on the mesh; restoring into such a tree gives
each of those leaves as its whole tensor on the host, for the caller to
place on whatever mesh it now runs (``TrainLoop.try_restore``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import is_namedtuple, tree_leaves_with_path
from repro_torch.quant.core import QTensor
from repro_torch.sharding.ctx import DataShards, Shards, join, whole_shape

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` that no later in-place write reaches."""
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:           # numpy has no bf16: its bits
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_host(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(dtype)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_save: bool = True,
                 shard_bytes: int = 256 * 1024 * 1024):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.shard_bytes = shard_bytes
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # ----- save -----
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()                 # one save deep
        leaves = []
        for key, v in tree_leaves_with_path(tree):
            if isinstance(v, DataShards):
                v = join(v, torch.device("cpu"))
            if isinstance(v, torch.Tensor):
                leaves.append((key, _to_host(v), _dtype_name(v.dtype)))
            else:
                leaves.append((key, v, None))
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, extra or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves, extra: Dict) -> None:
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": [], "shards": []}
        shard: Dict[str, np.ndarray] = {}
        shard_sz = 0

        def flush():
            nonlocal shard, shard_sz
            if not shard:
                return
            fn = f"shard_{len(manifest['shards']):05d}.npz"
            np.savez(os.path.join(tmp, fn), **shard)
            manifest["shards"].append(fn)
            shard, shard_sz = {}, 0

        for i, (key, arr, torch_dtype) in enumerate(leaves):
            if torch_dtype is None:
                manifest["leaves"].append({"key": key, "value": arr})
                continue
            name = f"leaf_{i:06d}"
            manifest["leaves"].append({
                "key": key, "name": name, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "torch_dtype": torch_dtype,
                "shard": len(manifest["shards"])})
            shard[name] = arr
            shard_sz += arr.nbytes
            if shard_sz >= self.shard_bytes:
                flush()
        flush()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write(str(time.time()))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    # ----- restore -----
    def all_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.root)):
            p = os.path.join(self.root, d)
            if (d.startswith("step_") and not d.endswith(".tmp")
                    and os.path.exists(os.path.join(p, "COMMITTED"))):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like``: leaf paths, shapes and
        dtypes are checked, each tensor lands on its ``like`` leaf's
        device."""
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = tree_leaves_with_path(like)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"leaf count mismatch: {len(leaves)} vs "
                             f"{len(manifest['leaves'])} saved")
        shards = [np.load(os.path.join(d, fn)) for fn in manifest["shards"]]
        try:
            vals = [self._leaf(shards, key, ref, meta) for (key, ref), meta
                    in zip(leaves, manifest["leaves"])]
        finally:
            for sh in shards:
                sh.close()
        return _unflatten(like, iter(vals)), manifest["extra"]

    @staticmethod
    def _leaf(shards, key: str, ref: Any, meta: Dict) -> Any:
        if meta["key"] != key:
            raise ValueError(f"leaf {key} restored from saved {meta['key']}")
        if isinstance(ref, DataShards):     # the whole tensor, on the host
            first = ref[0][0] if isinstance(ref[0], Shards) else ref[0]
            shape, dtype, device = whole_shape(ref), first.dtype, "cpu"
        elif isinstance(ref, torch.Tensor):
            shape, dtype, device = list(ref.shape), ref.dtype, ref.device
        else:
            if "value" not in meta:
                raise ValueError(f"{key}: saved a tensor, expected "
                                 f"{type(ref).__name__}")
            return meta["value"]
        if "value" in meta:
            raise ValueError(f"{key}: saved {meta['value']!r}, expected a "
                             "tensor")
        if shape != meta["shape"]:
            raise ValueError(f"{key}: shape {shape} != saved "
                             f"{meta['shape']}")
        if _dtype_name(dtype) != meta["torch_dtype"]:
            raise ValueError(f"{key}: dtype {_dtype_name(dtype)} != "
                             f"saved {meta['torch_dtype']}")
        arr = shards[meta["shard"]][meta["name"]]
        return _from_host(arr, dtype).to(device)

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like)
        return step, tree, extra


def _unflatten(like: Any, vals) -> Any:
    """A nest shaped like ``like`` holding ``vals`` in
    ``tree_leaves_with_path`` order (a ``DataShards`` leaf becomes its one
    whole tensor)."""
    if isinstance(like, DataShards):
        return next(vals)
    if isinstance(like, dict):
        return {k: _unflatten(v, vals) for k, v in like.items()}
    if isinstance(like, Shards):
        return like.like([_unflatten(v, vals) for v in like])
    if is_namedtuple(like):
        return type(like)(*(_unflatten(v, vals) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, vals) for v in like)
    if isinstance(like, QTensor):
        return QTensor(next(vals), next(vals), like.bits)
    return next(vals)
