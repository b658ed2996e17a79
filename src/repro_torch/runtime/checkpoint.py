"""Atomic, async, self-pruning checkpoints in the reference's on-disk layout
(the port of ``repro.runtime.checkpoint``).

* **Layout**: ``<dir>/step_%08d/`` holds one ``.npy`` per leaf, named by
  its ``/``-joined key path, and a ``manifest.json`` with the step, each
  key's file, shape and dtype, and ``extra`` (the data pipeline's state).
  The layout is the reference's, so a checkpoint the reference wrote
  restores here. numpy has no bfloat16: a bfloat16 leaf is stored as its
  raw 16-bit words with ``"bfloat16"`` as the manifest's dtype (the
  reference's files hold the same words, as a 2-byte void dtype).
* **Atomic**: written to ``step_%08d.tmp`` (every file fsynced), then
  renamed and the directory fsynced, so a crashed save never shows.
* **Async**: :class:`AsyncCheckpointer` copies every leaf to host memory
  before it returns (a copy even of a CPU tensor, whose ``.cpu()`` would
  share storage with a tensor the caller may update in place) and writes
  in a background thread.
* **Self-pruning**: keeps the newest ``keep`` checkpoints.
* **Sharded state** (``shardings=``, a tree of
  :class:`~repro_torch.parallel.sharding.Sharding`: a spec on a mesh of
  ranks per leaf): ``save`` all-gathers every leaf whole on every rank, in
  the caller's thread (a collective never runs in the writer thread); rank
  0 writes the layout above and the others wait at a barrier. So a mesh
  checkpoint is the one-device checkpoint of the same state: it restores
  on one device, in the reference's ``restore``, and on any other mesh,
  where ``restore(..., shardings=)`` hands each rank its slice.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import local_slices, replicate
from repro_torch.tree import flatten_with_paths, unflatten

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host numpy copy of ``leaf``, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _snapshot(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _host(v) for k, v in flatten_with_paths(tree).items()}


def _whole(tree, shardings):
    """(every leaf of ``tree`` gathered whole by its sharding, the mesh)."""
    flat_sh = flatten_with_paths(shardings)
    mesh = next(iter(flat_sh.values())).mesh
    out = {k: replicate(v, flat_sh[k].spec, flat_sh[k].mesh)
           for k, v in flatten_with_paths(tree).items()}
    return unflatten(tree, out), mesh


def save(directory: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3, shardings=None) -> str:
    """Blocking atomic save of a nested dict of tensors (or numpy arrays).
    Returns the final checkpoint path. With ``shardings`` every rank of the
    mesh calls it with its slices: the leaves are gathered whole, rank 0
    writes, and every rank returns once the checkpoint is published."""
    if shardings is None:
        return _write(directory, step, _snapshot(tree), extra, keep)
    whole, mesh = _whole(tree, shardings)
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        if mesh.rank == 0:
            path = _write(directory, step, _snapshot(whole), extra, keep)
    finally:
        mesh.barrier()
    return path


def _write(directory: str, step: int, snap, extra, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "keys": {}, "extra": extra or {}}
    for key, (arr, dtype) in snap.items():
        fn = _fname(key)
        with open(os.path.join(tmp, fn), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["keys"][key] = {"file": fn, "shape": list(arr.shape),
                                 "dtype": dtype}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # atomic publish
    _fsync_dir(directory)   # make the rename itself durable
    _prune(directory, keep)
    return final


def _fsync_dir(directory: str):
    """fsync the directory entry so that the rename survives a power loss
    (best effort where a directory cannot be opened)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def latest_step(directory: str) -> Optional[int]:
    """The newest published step under ``directory`` (a ``step_*`` folder
    with a manifest), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _load(path: str, meta: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == _BF16:
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, step: Optional[int] = None,
            template: Any = None,
            shardings: Any = None) -> Tuple[int, Any, Dict]:
    """Restore (step, tree, extra); ``step`` None takes the newest.

    With a ``template`` (a tree of tensors of the target structure) each
    leaf is cast to the template leaf's dtype and placed on its device; a
    key the checkpoint lacks raises ``KeyError``. Without one, the
    checkpoint's leaves come back as a flat ``{key: tensor}`` dict on the
    CPU. ``shardings`` (with a template; a tree of ``Sharding``, on any
    mesh): each leaf comes back as this rank's slice of it (the
    reference's ``device_put`` onto new shardings: elastic resharding)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    keys = manifest["keys"]
    if template is None:
        return step, {k: _load(path, v) for k, v in keys.items()}, \
            manifest["extra"]
    flat = flatten_with_paths(template)
    missing = set(flat) - set(keys)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    flat_sh = (flatten_with_paths(shardings) if shardings is not None
               else {})
    out = {}
    for k, leaf in flat.items():
        arr = _load(path, keys[k])
        if k in flat_sh:
            spec, mesh = flat_sh[k]
            arr = arr[local_slices(spec, tuple(arr.shape), mesh)].clone()
        out[k] = arr.to(device=leaf.device, dtype=leaf.dtype)
    return step, unflatten(template, out), manifest["extra"]


def _prune(directory: str, keep: int):
    steps = sorted(
        int(m.group(1)) for name in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", name)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer.

    ``save`` blocks only while it copies every leaf to host memory;
    serialization and IO run on the worker thread. ``wait()`` joins the
    save in flight and re-raises its error (call it before exit and before
    reading the directory). With ``shardings`` every rank calls ``save``:
    the leaves are gathered whole in the caller's thread, rank 0 writes in
    the background, and ``wait()`` ends at a barrier of every rank, so the
    checkpoint is published when any rank's ``wait()`` returns."""

    def __init__(self, keep: int = 3):
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None

    def save(self, directory: str, step: int, tree, extra=None,
             shardings=None):
        self.wait()
        if shardings is not None:
            tree, self._mesh = _whole(tree, shardings)
            if self._mesh.rank != 0:
                return
        snap = _snapshot(tree)

        def _work():
            try:
                _write(directory, step, snap, extra, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self, sync: bool = True):
        """Join the save in flight and re-raise its error; after a sharded
        save, meet every rank at a barrier unless ``sync`` is False (on the
        way out of a failure, when the other ranks may never arrive)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            if sync:
                mesh.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
