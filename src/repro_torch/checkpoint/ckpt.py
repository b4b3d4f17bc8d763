"""Checkpoints and named-array ``.npz`` files: the port of
``repro.checkpoint.ckpt``.

Both write the reference's manifest format: one ``.npz`` whose JSON
``manifest`` entry maps each leaf's path to an ``a<i>`` array key, so
either package reads what the other wrote.  Writes are atomic (a ``.tmp``
sibling, then a rename), so a crashed writer never leaves a step file half
written.

* ``save_arrays`` / ``load_arrays``: a flat ``{name: array}`` dict and a
  JSON ``meta`` record (the engine's artifact container).
* ``save_checkpoint`` / ``latest_step`` / ``restore_checkpoint``: a tree
  of nested dicts, lists and tuples whose leaves are tensors, numpy arrays
  or Python numbers, one ``step_{:08d}.npz`` per step.  A leaf's path is
  the reference's ``keystr`` (``['state']['params']['embed']['tok']``,
  ``[0]`` for a sequence item; dict keys in sorted order, as JAX flattens
  them), so a checkpoint of a plain dict tree written by one package
  restores in the other.  Restoring is device-agnostic: leaves come back
  on ``device`` (else where the ``like`` leaf lives), or wherever the
  caller's ``map_fn(path, array)`` puts them (the reference's elastic
  ``sharding_fn`` hook).
* ``CheckpointManager``: keep-k garbage collection and asynchronous
  writes on a thread, from a snapshot copied to host memory when ``save``
  is called, so the next step's in-place update cannot reach a write in
  flight.

Leaves are float32, int32 or int64: the train state is float32 masters
and moments and an int32 step count, the loop's own step an int64.  numpy
has no bfloat16, so any other dtype is refused by name.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Callable

import numpy as np
import torch

_STEP_FILE = re.compile(r"step_(\d+)\.npz$")
_DTYPES = (np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.int64))


def _atomic_savez(path: str, manifest: list, keyed: dict[str, np.ndarray],
                  extra: dict[str, str] | None = None) -> str:
    """Write one manifest-carrying ``.npz`` atomically (tmp then rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, manifest=json.dumps(manifest), **(extra or {}), **keyed)
    os.replace(tmp, path)
    return path


def save_arrays(path: str, arrays: dict[str, np.ndarray],
                meta: dict | None = None) -> str:
    """Write ``arrays`` and the optional ``meta`` dict to one ``.npz``."""
    keyed = {}
    manifest = []
    for i, (name, arr) in enumerate(arrays.items()):
        key = f"a{i}"
        keyed[key] = np.asarray(arr)
        manifest.append({"path": name, "key": key})
    return _atomic_savez(path, manifest, keyed,
                         extra={"meta": json.dumps(meta or {})})


def load_arrays(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Inverse of ``save_arrays``: ``(name -> array, meta dict)``."""
    with np.load(path, allow_pickle=False) as z:
        if "manifest" not in z:
            raise ValueError(
                f"{path} is not a manifest-format npz (no 'manifest' "
                "entry; was it written by plain np.savez?)")
        manifest = json.loads(str(z["manifest"]))
        meta = json.loads(str(z["meta"])) if "meta" in z else {}
        arrays = {m["path"]: z[m["key"]] for m in manifest}
    return arrays, meta


def _leaves(tree: Any, path: str = ""):
    """``(keystr path, leaf)`` in the reference's flattening order: dict
    keys sorted, sequence items in order, None an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _rebuild(tree: Any, fn: Callable, path: str = "") -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _host(path: str, leaf: Any, copy: bool) -> np.ndarray:
    """A leaf as a host numpy array of an accepted dtype; with ``copy`` it
    never shares memory with the leaf (``Tensor.numpy`` of a CPU tensor
    does)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype not in (torch.float32, torch.int32, torch.int64):
            raise TypeError(f"checkpoint leaf {path} has dtype {leaf.dtype}; "
                            f"checkpoints hold float32, int32 or int64 "
                            f"(numpy has no {leaf.dtype})")
        arr = leaf.to("cpu", copy=copy).numpy()
    else:
        arr = np.array(leaf, copy=copy) if copy else np.asarray(leaf)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"checkpoint leaf {path} has dtype {arr.dtype}; "
                        f"checkpoints hold float32, int32 or int64")
    return arr


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree``'s leaves to ``<directory>/step_{step:08d}.npz``."""
    os.makedirs(directory, exist_ok=True)
    keyed, manifest = {}, []
    for i, (path, leaf) in enumerate(_leaves(tree)):
        keyed[f"a{i}"] = _host(path, leaf, copy=False)
        manifest.append({"path": path, "key": f"a{i}"})
    return _atomic_savez(os.path.join(directory, f"step_{step:08d}.npz"),
                         manifest, keyed)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _STEP_FILE.match(f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any, device=None,
                       map_fn: Callable | None = None) -> Any:
    """Restore into the structure of ``like`` (values replaced).

    A tensor leaf comes back as a tensor of the ``like`` leaf's dtype and
    ``requires_grad``, on ``device`` or else on the ``like`` leaf's device
    (a ``meta`` tree from ``launch.steps.abstract_train_state`` describes
    a state without allocating it); any other leaf as a numpy array.
    ``map_fn(path, array)``, where it returns something other than None,
    makes the leaf itself.  A leaf missing from the checkpoint raises
    ``KeyError``, one of another shape ``ValueError``, each naming the
    path.
    """
    path = os.path.join(directory, f"step_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as z:
        keys = {m["path"]: m["key"] for m in json.loads(str(z["manifest"]))}

        def restore(ps: str, leaf: Any) -> Any:
            if ps not in keys:
                raise KeyError(f"checkpoint missing leaf {ps}")
            # read only the leaves ``like`` asks for (a server reads the
            # parameters of a checkpoint that also holds the moments)
            return _restored(ps, z[keys[ps]], leaf, device, map_fn)

        return _rebuild(like, restore)


def _restored(ps: str, arr: np.ndarray, leaf: Any, device,
              map_fn: Callable | None) -> Any:
    """One leaf of :func:`restore_checkpoint`."""
    shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch at {ps}: {arr.shape} vs {shape}")
    if map_fn is not None:
        out = map_fn(ps, arr)
        if out is not None:
            return out
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(arr).to(
            device=leaf.device if device is None else device,
            dtype=leaf.dtype)
        return t.requires_grad_(leaf.requires_grad)
    return np.asarray(arr, dtype=getattr(leaf, "dtype", None))


class CheckpointManager:
    """Keep-k checkpointing with optional async writes."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree: Any) -> None:
        """Snapshot ``tree`` to host memory now (a copy: the caller may
        update its tensors in place as soon as this returns), then write
        it, on a thread when ``async_save``."""
        arrays = _rebuild(tree, lambda p, leaf: _host(p, leaf, copy=True))
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_caught, args=(step, arrays), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays)

    def _write(self, step: int, arrays: Any) -> None:
        save_checkpoint(self.directory, step, arrays)
        self._gc()

    def _write_caught(self, step: int, arrays: Any) -> None:
        try:
            self._write(step, arrays)
        except BaseException as e:          # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(m.group(1)) for f in os.listdir(self.directory)
                       if (m := _STEP_FILE.match(f)))
        for s in steps[:-self.keep]:
            os.remove(os.path.join(self.directory, f"step_{s:08d}.npz"))

    def restore_latest(self, like: Any, device=None,
                       map_fn: Callable | None = None
                       ) -> tuple[int, Any] | None:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None
        return step, restore_checkpoint(self.directory, step, like, device,
                                        map_fn)
