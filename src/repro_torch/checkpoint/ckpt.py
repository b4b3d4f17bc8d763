"""Named-array + JSON-metadata ``.npz`` files (the artifact container).

The port's own copy of ``repro.checkpoint.ckpt.save_arrays`` /
``load_arrays``: the same manifest format (array names in a JSON
``manifest`` entry, arrays under ``a<i>`` keys, a JSON ``meta`` record),
so either package reads what the other wrote.  Writes are atomic (tmp
file, then rename).
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_arrays(path: str, arrays: dict[str, np.ndarray],
                meta: dict | None = None) -> str:
    """Write ``arrays`` and the optional ``meta`` dict to one ``.npz``."""
    keyed = {}
    manifest = []
    for i, (name, arr) in enumerate(arrays.items()):
        key = f"a{i}"
        keyed[key] = np.asarray(arr)
        manifest.append({"path": name, "key": key})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, manifest=json.dumps(manifest),
                 meta=json.dumps(meta or {}), **keyed)
    os.replace(tmp, path)
    return path


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
