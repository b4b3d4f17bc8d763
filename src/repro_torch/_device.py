"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` / ``"cuda[:n]"`` as given.

    A CUDA device without a card raises instead of quietly running on the
    CPU: the plain versions there are for tests, and a caller must ask for
    them by name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch versions on the CPU")
    return dev


_ABSTRACT = threading.local()


@contextlib.contextmanager
def abstract_run():
    """Inside, a kernel wrapper given ``meta`` tensors computes its plain
    version on them (shapes and dtypes, no storage, no launch): the
    dry-run traces a step so.  Outside, ``meta`` tensors raise, as any
    device but ``cuda`` and ``cpu`` does."""
    prev = getattr(_ABSTRACT, "on", False)
    _ABSTRACT.on = True
    try:
        yield
    finally:
        _ABSTRACT.on = prev


def plain_device(dev: torch.device) -> bool:
    """True where a kernel wrapper runs its plain version: the CPU, and
    ``meta`` inside :func:`abstract_run`."""
    return dev.type == "cpu" or (dev.type == "meta"
                                 and getattr(_ABSTRACT, "on", False))
