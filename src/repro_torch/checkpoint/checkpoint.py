"""Checkpoints of the port's trees in the reference's on-disk format
(`src/repro/checkpoint/checkpoint.py`), so a checkpoint written by
either package restores in the other.

Layout:  <dir>/step_<N>/
            manifest.json       step, meta, per-leaf shape and dtype
            arrays.npz          one entry per leaf, named by its key path
         <dir>/LATEST           atomic pointer file

A leaf is named by its path in the tree, as JAX's
`tree_flatten_with_path` spells it: a dict key as itself, a list index
as `[i]`, joined by "/" (in the `.npz` by "|", which an entry name may
hold).  Names, not positions, tie a leaf to its array: JAX flattens a
dict in sorted key order, the port's `tree_leaves` in insertion order.
bf16 is stored as its `uint16` bits with `"dtype": "bfloat16"` in the
manifest (npz has no bf16) and read back through an `int16` view, with
no `ml_dtypes`.

As in the reference: `arrays.npz` is written by `np.savez` and read by
`np.load` (which checks each member's CRC-32), publication is atomic
(written to `step_N.tmp/`, the manifest fsynced, renamed, then `LATEST`
replaced), the newest `keep` checkpoints are kept, and
`AsyncCheckpointer` saves on one background thread, the newest pending
state winning.  Its `submit` takes a host copy of every leaf first:
AdamW writes the state's tensors in place (`optim/adamw.py`), and on the
CPU a tensor's numpy view would change under a pending save.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.param import tree_map


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(key path, leaf) of every leaf, in the tree's own order."""
    if isinstance(tree, dict):
        return [kl for k, v in tree.items()
                for kl in _flatten_with_paths(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree)
                for kl in _flatten_with_paths(v, prefix + (f"[{i}]",))]
    return [("/".join(prefix), tree)]


def _structure(tree) -> str:
    """A readable spelling of the tree's nesting, for the manifest (the
    reference writes JAX's treedef there; neither package reads it)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(v)}"
                               for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array the `.npz` stores and its logical dtype.
    A CPU tensor's array shares its memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    meta: Optional[dict] = None, keep: int = 3) -> str:
    """Blocking save of a tree of tensors (or numpy arrays).  Returns the
    checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    entries = {}
    for key, leaf in _flatten_with_paths(tree):
        arr, logical = _host(leaf)
        arrays[key.replace("/", "|")] = arr      # npz names cannot hold '/'
        entries[key] = {"shape": list(arr.shape), "dtype": logical}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "meta": meta or {}, "entries": entries,
                "treedef": _structure(tree), "time": time.time()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr_tmp = os.path.join(directory, "LATEST.tmp")    # atomic LATEST
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int):
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def _as_tensor(arr: np.ndarray, saved: str, want: torch.dtype
               ) -> torch.Tensor:
    """A stored array as a CPU tensor of dtype `want` (bf16 from its bits;
    another float saved into a bf16 leaf rounded to nearest even, as the
    reference's `astype` rounds)."""
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if saved == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
        if want == torch.bfloat16:
            t = t.to(torch.float32)
    return t.to(want)


def restore_checkpoint(directory: str, like_tree, *,
                       step: Optional[int] = None, device=None
                       ) -> Tuple[Any, dict]:
    """Restore into the structure and dtypes of `like_tree` (tensors, meta
    tensors included).  Each leaf goes to `device` if given, else to its
    like leaf's device, and a meta leaf's to the card (`resolve_device`).
    Returns (tree, meta)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    entries = manifest.get("entries", {})
    flat = _flatten_with_paths(like_tree)
    if device is None and any(t.device.type == "meta" for _, t in flat):
        card = resolve_device(None)

    def target(like):
        if device is not None:
            return torch.device(device)
        return card if like.device.type == "meta" else like.device

    keys = iter(key for key, _ in flat)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        def leaf(like):
            key = next(keys)
            enc = key.replace("/", "|")
            if enc not in npz:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = npz[enc]
            saved = entries.get(key, {}).get("dtype", str(arr.dtype))
            return _as_tensor(arr, saved, like.dtype).to(target(like))
        tree = tree_map(leaf, like_tree)
    return tree, manifest.get("meta", {})


class AsyncCheckpointer:
    """Fire-and-forget background saves (single writer thread, queue depth
    1: if a save is pending, the newest state wins)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[Tuple[int, Any, dict]] = None
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self.errors: List[str] = []

    def submit(self, step: int, tree, meta: Optional[dict] = None):
        """Queue a save of `tree` as it is now: every leaf is copied to the
        host before this returns."""
        host_tree = tree_map(
            lambda t: t.detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else np.array(t), tree)
        with self._lock:
            self._pending = (step, host_tree, meta or {})
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self):
        while True:
            with self._lock:
                if self._pending is None:
                    return
                step, tree, meta = self._pending
                self._pending = None
            try:
                save_checkpoint(self.directory, step, tree, meta, self.keep)
                self.last_saved = step
            except Exception as e:  # reported through `errors`
                self.errors.append(f"step {step}: {e}")

    def wait(self, timeout: Optional[float] = None):
        """Wait for the pending saves (until they are written, unless a
        `timeout` in seconds is given: a TinyLlama-1.1B train state is
        11 GB, whose save may outlast the reference's 60 s)."""
        t = self._thread
        if t is not None:
            t.join(timeout)
