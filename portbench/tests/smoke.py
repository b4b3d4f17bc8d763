"""Smoke-size cells for the CPU tests: the qwen3 family of the cells and
the hybrid family the reference also holds (its SSD, for a later cell),
each at a few layers and narrow widths, and small traffic of each kind."""

from __future__ import annotations

import copy
from pathlib import Path

from portbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]

QWEN = {"arch_id": "qwen3-smoke", "n_layers": 2, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
        "vocab": 256, "block_kind": "attn", "qk_norm": True,
        "rope_theta": 1e6, "norm_eps": 1e-6, "tie_embeddings": True,
        "act_fn": "silu", "compute_dtype": "bfloat16",
        "param_dtype": "float32", "remat": "full", "attn_chunk": 16,
        "logicnet_ffn": {"fan_in": 16, "bw": 4, "max_val": 4.0}}
ZAMBA = {"arch_id": "zamba2-smoke", "n_layers": 4, "d_model": 64,
         "n_heads": 4, "n_kv_heads": 4, "head_dim": 0, "d_ff": 128,
         "vocab": 256, "block_kind": "ssm",
         "ssm": {"d_state": 16, "head_dim": 16, "expand": 2,
                 "conv_width": 4, "chunk": 16, "n_groups": 1},
         "hybrid_attn_every": 2, "qk_norm": False, "rope_theta": 1e4,
         "norm_eps": 1e-5, "tie_embeddings": True, "act_fn": "silu",
         "compute_dtype": "bfloat16", "param_dtype": "float32",
         "remat": "full", "attn_chunk": 16,
         "logicnet_ffn": {"fan_in": 16, "bw": 4, "max_val": 4.0}}
CONFIGS = {"qwen3": QWEN, "zamba2": ZAMBA}
TRAIN = {"batch": 4, "seq_len": 64}
PREFILL = {"tokens_per_call": 128,
           "lengths": {"median": 32, "sigma": 1.0, "min": 16, "max": 128,
                       "multiple": 16, "block": 4},
           "check_per_length": 2, "trace_calls": 3}
# the output check's limits at these sizes, set as the cells' are: above
# the largest sound reading of a dozen seeds, below the float8 control's
# smallest of three and the faults' (bfloat16 on the CPU; sound / control
# / half batch: qwen3 loss 5.2e-5 / 1.9e-4 / 2.6e-3, gradient 0.023 / 0.030
# / 0.18; zamba2 loss 1.6e-4 / 5.8e-4 / 1.8e-3, gradient 0.035 / 0.087 /
# 0.15, change 0.045 / 0.058 / 0.086, a state left unchanged 1; prefill
# token gap over 24 seeds / 6 control seeds qwen3 0.0028 / 0.0154; zamba2
# 0.040 / 0.061, too close for its control to be tested, so its limit
# holds only the sound run and the faults)
LIMITS = {("qwen3", "train"): {"loss_gap": 1.2e-4, "grad_gap": 0.06,
                               "change_gap": 0.3},
          ("zamba2", "train"): {"loss_gap": 3.5e-4, "grad_gap": 0.07,
                                "change_gap": 0.3},
          ("qwen3", "prefill"): {"token_gap": 0.007},
          ("zamba2", "prefill"): {"token_gap": 0.06}}


def cell(config: str, kind: str, **compute) -> spec.Cell:
    """A cell of the repository's BENCHMARK.json of ``kind``, at smoke
    size: the ``config`` family's smoke config (``compute`` overriding its
    keys), the kind's traffic cut to a few short rows."""
    name = ("qwen3-1.7b-lnffn.train.4x2048" if kind == "train"
            else "qwen3-1.7b-lnffn.prefill.mix")
    c = spec.cell(ROOT, name)
    c.config = dict(copy.deepcopy(CONFIGS[config]), **compute)
    c.traffic = dict(c.traffic, **(TRAIN if kind == "train" else PREFILL))
    c.limits = dict(LIMITS[config, kind])
    return c
