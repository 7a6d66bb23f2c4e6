"""npz checkpointing with manifests, async writes, and restore onto any
device (the reference's ``runtime/checkpoint.py``).

Layout::

    <dir>/step_000123/
        manifest.json      # step, flat keys, shapes/dtypes, extra:
                           # written LAST (commit marker)
        arrays_00000.npz   # flat key → ndarray

A checkpoint is valid iff its manifest exists (atomic rename), so a crash
mid-write never yields a half-checkpoint that restore would trust:
`latest_step` only considers committed manifests.  ``AsyncCheckpointer``
moves the write off the training loop: the device → host copy is taken
when ``save`` is called, the file is written while the next steps run;
``wait()`` bounds in-flight writes to one.

A tree is nested dicts, lists, tuples and NamedTuples of tensors (or
numpy arrays), with None for an empty subtree; an ``nn.Module`` stands
for its ``state_dict``.  Keys join the path with ``::``.  numpy has no
bfloat16 here, so a bfloat16 tensor is stored as its 16 bits (uint16)
with ``"bfloat16"`` in the manifest.  ``restore`` rebuilds the structure
of ``like`` with each tensor on its leaf's device (or on ``device``): the
re-mesh of this port is a restore onto another device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

SEP = "::"


def _items(tree):
    """A node's (key, child) pairs, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if tree is None:
        return {}
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for key, child in items:
        flat.update(_flatten(child, f"{prefix}{SEP}{key}" if prefix
                             else str(key)))
    return flat


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf → (a numpy copy, its dtype's name)."""
    if not torch.is_tensor(leaf):
        a = np.array(leaf)
        return a, str(a.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _write(ckpt_dir: str, step: int, arrays, extra) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays_00000.npz"),
             **{k: a for k, (a, _) in arrays.items()})
    manifest = {
        "step": step,
        "keys": {k: [list(a.shape), dt] for k, (a, dt) in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None
         ) -> str:
    """Blocking save.  Returns the checkpoint path."""
    return _write(ckpt_dir, step, {k: _to_host(v) for k, v in
                                   _flatten(tree).items()}, extra)


def _committed(ckpt_dir: str):
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name,
                                            "manifest.json")):
            yield int(name.split("_")[1])


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    return max(_committed(ckpt_dir), default=None)


def _rebuild(like, out: Dict[str, torch.Tensor], prefix: str = ""):
    if like is None:
        return None
    items = _items(like)
    if items is None:
        return out[prefix]

    def key(k):
        return f"{prefix}{SEP}{k}" if prefix else str(k)

    if isinstance(like, nn.Module):
        like.load_state_dict({k: out[key(k)] for k, _ in items})
        return like
    children = [_rebuild(child, out, key(k)) for k, child in items]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*children)
    if isinstance(like, dict):
        return {k: c for (k, _), c in zip(items, children)}
    return type(like)(children)


def restore(ckpt_dir: str, step: int, like, device=None):
    """Restore into the structure of ``like`` → (tree, extra).  Each
    tensor lands on its ``like`` leaf's device, or on ``device`` when one
    is given; a module in ``like`` is loaded in place (on its own
    device) and returned.  A missing key raises KeyError, a shape that
    differs from its leaf's ValueError."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(like)
    with np.load(os.path.join(path, "arrays_00000.npz")) as data:
        missing = set(flat_like) - set(data.files)
        if missing:
            raise KeyError(f"checkpoint missing keys: "
                           f"{sorted(missing)[:5]} ...")
        out = {}
        for k, leaf in flat_like.items():
            arr = data[k]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{k}: ckpt shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            dev = device or (leaf.device if torch.is_tensor(leaf) else "cpu")
            out[k] = _from_host(arr, manifest["keys"][k][1]).to(dev)
    return _rebuild(like, out), manifest["extra"]


class AsyncCheckpointer:
    """One background writer thread; at most one in-flight save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, step: int, tree, extra=None):
        self.wait()
        # the device → host copy happens here (synchronously), so the
        # caller may update the live tensors in place; the write is async
        arrays = {k: _to_host(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                _write(self.dir, step, arrays, extra)
                self._gc()
            except BaseException as e:     # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _gc(self):
        for s in sorted(_committed(self.dir))[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)


def config_hash(cfg) -> str:
    return hashlib.sha1(
        json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                   default=str).encode()).hexdigest()[:12]
