"""Fault-tolerant checkpointing: atomic, async (port of
`repro.checkpoint.checkpointer`).

Layout, as the reference's: ``<dir>/step_<N>/arrays.npz`` and
``manifest.json`` (``step``, ``time``, the sorted ``keys``), written into
``step_<N>.tmp`` and published by ``os.rename``, so a crash mid-write never
leaves a half-written latest checkpoint; the newest ``keep`` steps are
retained.  Keys join dict keys and list indices with ``/`` as the
reference's ``_flatten`` joins ``jax.tree_util.tree_flatten_with_path``
(``params/layers/3/attn/wq``), so a checkpoint of the same nested tree
reads back in either package.

The port's AdamW updates parameters and moments in place, so `save`
copies every leaf to the host before it returns (a fresh host tensor, also
for a CPU leaf) and the writer thread saves that snapshot while training
goes on.  Leaves are tensors, NumPy arrays or Python numbers; a tensor of
a dtype NumPy lacks (bf16) raises `TypeError` (the trainer saves f32
masters and moments only).  `restore` casts each leaf to the dtype of the
matching leaf of ``like`` and places it on that leaf's device, on
``device=`` when given, or under ``shardings=`` as the reference's
``jax.device_put`` does: a tree like ``like`` of
`repro_torch.launch.mesh.NamedSharding`s of any partition spec, each
tensor leaf placed with `repro_torch.launch.mesh.place` (a `Sharded` value
with a block per mesh device, or a tensor where the spec splits nothing),
so a checkpoint restores onto a mesh of any size and layout.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import place

__all__ = ["Checkpointer", "latest_step", "flatten"]


def flatten(state: Any) -> dict[str, Any]:
    """``{key: leaf}`` in the reference's order: dict values by sorted key,
    list and tuple items by index, keys joined by ``/``."""
    out: dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + (str(i),))
        elif node is not None:  # None is an empty subtree, as in jax.tree
            out["/".join(path)] = node
    walk(state, ())
    return out


def _unflatten(like: Any, values: dict[str, Any], path=()) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], values, path + (str(k),)) for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(x, values, path + (str(i),)) for i, x in enumerate(like)]
        return type(like)(items)
    if like is None:
        return None
    return values["/".join(path)]


def _host(key: str, leaf: Any) -> np.ndarray:
    """A host snapshot of ``leaf`` that no later in-place update reaches."""
    if isinstance(leaf, torch.Tensor):
        try:
            torch.empty((), dtype=leaf.dtype).numpy()
        except TypeError:
            raise TypeError(
                f"checkpoint: leaf {key!r} is {leaf.dtype}, which NumPy cannot hold; "
                f"save f32 masters (cast explicitly if a rounded copy is meant)"
            ) from None
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _steps(directory: str) -> list[int]:
    return [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]


def latest_step(directory: str) -> int | None:
    """The newest published step under ``directory``; ``.tmp`` ignored."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


class Checkpointer:
    """Saves and restores nested dicts and lists of leaves under
    ``directory``.  Host seconds are kept per call: ``save_s`` (the
    snapshot, which the caller waits for), ``write_s`` (the writer, on its
    thread when ``async_save``) and ``restore_s``."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self.save_s: list[float] = []
        self.write_s: list[float] = []
        self.restore_s: list[float] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- saving
    def save(self, step: int, state: Any, block: bool = False) -> None:
        """Snapshot ``state`` at ``step``; the write runs on a thread
        unless ``block`` or the checkpointer is synchronous."""
        t0 = time.perf_counter()
        host = {k: _host(k, v) for k, v in flatten(state).items()}
        self.save_s.append(time.perf_counter() - t0)
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {"step": step, "time": time.time(), "keys": sorted(host)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        self.write_s.append(time.perf_counter() - t0)

    def _gc(self) -> None:
        for s in sorted(_steps(self.dir))[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def wait(self) -> None:
        """Block until the in-flight write, if any, is published."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # ------------------------------------------------------------ restore
    def restore(
        self,
        step: int,
        like: Any,
        device: str | torch.device | None = None,
        shardings: Any = None,
    ) -> Any:
        """``like``'s structure with the leaves saved at ``step``, each cast
        to ``like``'s dtype: tensors on ``device``, under their entry of
        ``shardings`` (a tree like ``like``; a missing entry leaves its leaf
        on ``like``'s device), or else on the device of ``like``'s leaf;
        NumPy arrays as NumPy, Python numbers as their type.  Missing keys
        raise `KeyError`, other shapes `ValueError`, ``device`` with
        ``shardings`` `ValueError`."""
        if device is not None and shardings is not None:
            raise ValueError("restore: pass device= or shardings=, not both")
        t0 = time.perf_counter()
        flat_like = flatten(like)
        flat_sh = {} if shardings is None else flatten(shardings)
        out = {}
        with np.load(os.path.join(self.dir, f"step_{step}", "arrays.npz")) as data:
            missing = set(flat_like) - set(data.files)
            if missing:
                raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}")
            for k, ref in flat_like.items():
                arr = data[k]
                shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{k}: checkpoint shape {arr.shape} != expected {shape}")
                if isinstance(ref, torch.Tensor) and k in flat_sh:
                    out[k] = place(torch.from_numpy(arr).to(ref.dtype), flat_sh[k])
                elif isinstance(ref, torch.Tensor):
                    out[k] = torch.from_numpy(arr).to(
                        device=ref.device if device is None else device, dtype=ref.dtype)
                elif isinstance(ref, np.ndarray):
                    out[k] = arr.astype(ref.dtype)
                else:  # a Python number: the AdamW count is an int
                    out[k] = type(ref)(arr)
        self.restore_s.append(time.perf_counter() - t0)
        return _unflatten(like, out)
