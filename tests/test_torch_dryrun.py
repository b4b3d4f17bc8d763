"""The port's dry-run (``launch.dryrun``) on the CPU.

* The fields a cell's record takes from its config alone (``kind``,
  ``params``, ``active_params``, ``seq_len``, ``global_batch``, and a
  skipped cell's ``status`` and ``skip_reason``) equal the reference's
  ``get_config`` / ``param_count`` / ``active_param_count`` /
  ``cell_skip`` for all 40 arch x shape cells.
* In subprocesses (a fake process group is process-global): the
  reference's mini-cell (seq 64, batch 8, train) of qwen3-1.7b,
  olmoe-1b-7b and zamba2-2.7b smoke on a fake 2x4 mesh traces with FLOPs
  and collectives (the asserts the reference's own
  ``test_mini_multidevice_dryrun_subprocess`` can no longer reach on this
  JAX); the qwen3 cell's per-device FLOPs are within 10 % of a count by
  hand; and both production meshes (256 and 512 fake ranks) build, with
  ``model``, ``data`` and, on the multi-pod one, ``pod`` on weights.
"""

import json
import os
import subprocess
import sys
import types

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_skip as ref_cell_skip
from repro.configs import get_config as ref_get_config

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH

from torch_port_util import SRC

TIMEOUT_S = 300


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return env


def _run(script: str, *args) -> str:
    proc = subprocess.run([sys.executable, "-c", script, *args], env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_free_fields_equal_reference(arch, shape):
    args = DR.parse_args([])
    rec = DR.mesh_free_record(DR.apply_variants(get_config(arch), args),
                              arch, shape, "16x16", args.variant,
                              SHAPES[shape])
    ref_cfg = ref_get_config(arch)
    cell = REF_SHAPES[shape]
    want = {"kind": cell.kind, "params": ref_cfg.param_count(),
            "active_params": ref_cfg.active_param_count(),
            "seq_len": cell.seq_len, "global_batch": cell.global_batch}
    skip = ref_cell_skip(ref_cfg, shape)
    if skip:
        want.update(status="skipped", skip_reason=skip)
    assert {k: rec.get(k) for k in want} == want
    assert ("status" in rec) == bool(skip)


MINI = """
import json, sys
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import _init_fake
from repro_torch.parallel import sharding as SH

_init_fake(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = get_smoke_config(sys.argv[1])
cell = ShapeCell("mini", seq_len=64, global_batch=8, kind="train")
arg_bytes, flops, coll = DR.trace_step(cfg, cell, mesh, SH.ShardingPolicy(),
                                       DR.parse_args([]))
print(json.dumps({"flops": flops, "coll": DR.collective_bytes(coll),
                  "arg_bytes": arg_bytes}))
"""


@pytest.fixture(scope="module")
def mini_cells():
    return {}


def _mini(cache, arch):
    if arch not in cache:
        cache[arch] = json.loads(_run(MINI, arch).strip().splitlines()[-1])
    return cache[arch]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_mini_multidevice_dryrun_subprocess(arch, mini_cells):
    rec = _mini(mini_cells, arch)
    assert rec["flops"] > 0
    assert rec["coll"]["total"] > 0          # the DP grad sync exists
    assert rec["coll"]["n_all-gather"] > 0   # FSDP gathers weights
    assert rec["arg_bytes"] > 0


def test_mini_cell_flops_match_a_count_by_hand(mini_cells):
    """qwen3-1.7b smoke on 2x4, batch 8 x 64, train: 6 x per-device
    parameters x per-device tokens, plus attention.  The FSDP axis gathers
    every weight where it is used, so a device's products use each
    parameter over the model axis's share of it: its numel over the
    model-axis shards its spec names (the 2 kv heads, which cannot split
    4 ways, whole); the tied embedding counts once, as the LM head.
    Attention (chunk 64 = seq, so one block): QK^T and PV, 2 x B x Hq x
    S^2 x hd each forward, on the device's batch and q heads, x 3 for
    forward and backward."""
    cfg = get_smoke_config("qwen3-1.7b")
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    policy = SH.ShardingPolicy()
    params = 0
    for name, shape in M.param_shapes(cfg).items():
        if len(shape) < 2:
            continue                         # norms: no products
        spec = SH.spec_for_path(name, shape, policy, mesh)
        n = 1
        for d in shape:
            n *= d
        params += n // (4 if "model" in spec else 1)
    batch, seq = 8 // 2, 64
    hand = 6 * params * batch * seq
    hq = cfg.n_heads // 4
    hand += cfg.n_layers * 3 * 2 * (2 * batch * hq * seq * seq
                                    * cfg.resolved_head_dim)
    got = _mini(mini_cells, "qwen3-1.7b")["flops"]
    assert abs(got - hand) <= 0.1 * hand, (got, hand)


MESH_512 = """
from repro_torch.configs import get_config
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as SH

for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    assert mesh.size() == (512 if mp else 256), mesh
    policy = SH.multi_pod_policy() if mp else SH.ShardingPolicy()
    params = S.abstract_params(get_config("qwen3-1.7b"))
    specs = SH.tree_specs(params, mesh, policy)
    axes = set()
    for spec in specs.values():
        for a in spec:
            if a is not None:
                axes |= set(a) if isinstance(a, tuple) else {a}
    assert "model" in axes and "data" in axes
    if mp:
        assert "pod" in axes, "pod axis must shard weights"
    # and the placements put them there on the DeviceMesh
    pl = SH.shardings_for_tree(params, mesh, policy)["layers.0.attn.wq"]
    assert [p.is_shard() for p in pl] == [True] * mesh.ndim, pl
print("mesh512 ok")
"""


def test_production_mesh_512_and_pod_axis_shards():
    assert "mesh512 ok" in _run(MESH_512)
