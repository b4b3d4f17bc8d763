"""Progress notes on standard error, each with the seconds since the
process's first note."""

from __future__ import annotations

import sys
import time

_T0 = time.perf_counter()


def note(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", file=sys.stderr,
          flush=True)
