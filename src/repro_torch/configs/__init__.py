"""Model configurations of the port: the LM-zoo registry and fpga4hep.

The port's copy of ``repro.configs``: ``get_config(arch_id)`` returns an
architecture's full published config, ``get_smoke_config(arch_id)`` its
reduced same-family config.  ``SHAPES`` are the four input-shape cells;
``cell_skip`` encodes which cells a family skips.  Every architecture is
listed here, whether or not the port's model can run it yet: a family it
cannot run raises in ``repro_torch.models.model``, never in this registry.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelCfg

ARCH_IDS = [
    "qwen3-moe-235b-a22b",
    "olmoe-1b-7b",
    "gemma3-27b",
    "qwen3-1.7b",
    "starcoder2-15b",
    "phi3-mini-3.8b",
    "zamba2-2.7b",
    "mamba2-370m",
    "whisper-medium",
    "qwen2-vl-2b",
]


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelCfg:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelCfg:
    return _module(arch_id).smoke_config()


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_skip(cfg: ModelCfg, shape: str) -> str | None:
    """Reason the (arch, shape) cell is skipped, or None if it runs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        if cfg.local_global_ratio > 0:
            return ("full-attention global layers every "
                    f"{cfg.local_global_ratio + 1} layers keep 512k "
                    "quadratic (see DESIGN.md)")
        return "pure full-attention arch: 512k decode is quadratic-cost"
    return None
