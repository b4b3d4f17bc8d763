"""Expert-parallel MoE and head-parallel SSM blocks on a mesh.

* On a fake (2, 4) mesh (8 ranks of a ``fake`` process group, ``meta``
  tensors, as ``launch.dryrun`` traces): one MoE FFN forward of
  olmoe-1b-7b smoke (4 experts, one a model rank) and one SSM block
  forward of mamba2-370m smoke (8 heads, two a model rank).  Each rank's
  FLOPs (``dryrun.LocalFlops``) equal a count by hand with the experts
  at E / 4 and the SSM's projections at their rank's columns and rows,
  within 10 %; no all-gather (``hlo_stats.CollectiveRecorder``) holds
  all the experts or the whole ``in_proj``; each block's output is a
  partial sum over ``model``.  One ``ssm_decode`` step there, where a
  rank's tokens are fewer than ``d_model``: the rank projects on its
  even share of the columns and regroups the activation in their place,
  and the SSD state stays heads over ``model``.
* mamba2-370m smoke with 2 groups of B and C (two heads a rank, so each
  rank's heads lie in one group) on a (1, 4) mesh of 4 gloo CPU
  processes: ``ssm_apply`` on a 4 x 32 batch, then ``ssm_decode`` for 3
  steps, each fed the state the last returned; the SSD state stays on
  ``cache_specs``' placements (heads over ``model``), the conv ring
  replicated there, and outputs and states equal one process's within
  1e-5 at float32.
"""

import json
import os
import subprocess
import sys

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.models import moe, ssm

from torch_port_util import SRC, run_ranks

TIMEOUT_S = 240
GROUP = 128                     # MoE token groups: each data rank's 256
B, S = 8, 64                    # tokens are two whole groups

FAKE = r"""
import json, sys
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch._device import abstract_run
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.hlo_stats import CollectiveRecorder
from repro_torch.launch.mesh import _init_fake
from repro_torch.models import model as M, moe, ssm
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.ctx import activation_sharding

_init_fake(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
policy = SH.ShardingPolicy()
moe.GROUP_TOKENS = int(sys.argv[1])
b, s = int(sys.argv[2]), int(sys.argv[3])
out = {}
for name, arch, key, init, apply in (
        ("moe", "olmoe-1b-7b", "moe", moe.moe_init,
         lambda p, c, x: moe.moe_apply(p, c, x)[0]),
        ("ssm", "mamba2-370m", "ssm", ssm.ssm_init, ssm.ssm_apply)):
    cfg = get_smoke_config(arch)
    with abstract_run():
        p = init(torch.Generator().manual_seed(0), cfg, torch.float32)
        p = SH.distribute({f"layers.0.{key}.{k}": v.to("meta")
                           for k, v in p.items()}, mesh, policy)
        p = {k.split(".")[-1]: v for k, v in p.items()}
        x = SH.distribute_leaf(torch.empty((b, s, cfg.d_model),
                                           device="meta"),
                               mesh, SH.placements(("data",), mesh))
        flops, coll = DR.LocalFlops(), CollectiveRecorder()
        with activation_sharding(mesh, SH.activation_rules(policy)), \
                flops, coll:
            y = apply(M.cast_weights(p, torch.float32), cfg, x)
    out[name] = {"flops": flops.flops, "coll": coll.record,
                 "out": [repr(pl) for pl in y.placements],
                 "local": list(p["wi_gate" if key == "moe" else
                                 "in_proj"].to_local().shape)}
# one decode step: b tokens, b / 2 a data rank, fewer than d_model
with abstract_run():
    p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    p = SH.distribute({f"layers.0.ssm.{k}": v.to("meta")
                       for k, v in p.items()}, mesh, policy)
    p = M.cast_weights({k.split(".")[-1]: v for k, v in p.items()},
                       torch.float32)
    st = ssm.ssm_decode_state(cfg, b, device="meta")
    st = {"ssd": SH.distribute_leaf(st["ssd"], mesh,
                                    SH.placements(("data", "model"), mesh)),
          "conv": SH.distribute_leaf(st["conv"], mesh,
                                     SH.placements(("data",), mesh))}
    u = SH.distribute_leaf(torch.empty((b, 1, cfg.d_model), device="meta"),
                           mesh, SH.placements(("data",), mesh))
    coll = CollectiveRecorder()
    with activation_sharding(mesh, SH.activation_rules(policy)), coll:
        y, st = ssm.ssm_decode(p, cfg, u, st)
out["ssm_decode"] = {"coll": coll.record,
                     "out": [repr(pl) for pl in y.placements],
                     "ssd": [repr(pl) for pl in st["ssd"].placements]}
print(json.dumps(out))
"""


def _fake() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run([sys.executable, "-c", FAKE, str(GROUP), str(B),
                           str(S)], env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _moe_by_hand(cfg) -> int:
    """One rank's products: the router on its tokens, the one-hot
    dispatch and combine masks, the dispatch and combine products and the
    SwiGLU experts, each on its one expert's slots."""
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.moe.top_k
    tokens = B // 2 * S
    groups, el = tokens // GROUP, e // 4
    cap = moe.capacity(cfg, GROUP)
    return (2 * tokens * d * e + 4 * tokens * el * k * cap
            + 4 * tokens * el * cap * d + 6 * el * groups * cap * d * f)


def _ssm_by_hand(cfg) -> int:
    """One rank's products: ``in_proj`` on its heads' columns (z and x of
    2 heads, B and C whole, 2 dt), ``out_proj`` on its 2 heads' rows, and
    the chunked scan's four products on its 2 heads."""
    c = cfg.ssm
    d_in = c.expand * cfg.d_model
    heads = d_in // c.head_dim // 4
    cols = 2 * heads * c.head_dim + 2 * c.d_state + heads
    tokens = B // 2 * S
    bs, nc, L = B // 2, S // c.chunk, c.chunk
    scan = 2 * bs * nc * L * L * c.d_state + 2 * bs * nc * heads * (
        L * L * c.head_dim + 2 * L * c.head_dim * c.d_state)
    return (2 * tokens * cfg.d_model * cols
            + 2 * tokens * heads * c.head_dim * cfg.d_model + scan)


def test_fake_mesh_flops_and_no_whole_gathers():
    got = _fake()
    mo, sm = got["moe"], got["ssm"]
    cfg_m, cfg_s = get_smoke_config("olmoe-1b-7b"), get_smoke_config(
        "mamba2-370m")
    for rec, hand in ((mo, _moe_by_hand(cfg_m)), (sm, _ssm_by_hand(cfg_s))):
        assert abs(rec["flops"] - hand) <= 0.1 * hand, (rec["flops"], hand)
        assert rec["out"] == ["Shard(dim=0)", "Partial(sum)"], rec["out"]
    d, f, e = cfg_m.d_model, cfg_m.d_ff, cfg_m.moe.n_experts
    assert mo["local"] == [e // 4, d // 2, f]
    experts = e * d * f * 4
    gathers = [n for kind, n in mo["coll"] if kind == "all-gather"]
    assert gathers and max(gathers) < experts, (gathers, experts)
    d_in, heads, _ = ssm._dims(cfg_s)
    proj = 2 * d_in + 2 * cfg_s.ssm.d_state + heads
    assert sm["local"] == [cfg_s.d_model // 2, proj // 4]
    gathers = [n for kind, n in sm["coll"] if kind == "all-gather"]
    whole = cfg_s.d_model * proj * 4
    assert gathers and max(gathers) < whole, (gathers, whole)
    # the rank's in_proj columns, conv_w and conv_b come by all-to-all:
    # 2 heads' z and x (32 columns each), B and C (16 each) and 2 dt
    cols = 2 * 32 + 2 * 16 + 2
    a2a = [n for kind, n in sm["coll"] if kind == "all-to-all"]
    assert a2a[0] == cfg_s.d_model * cols * 4 and len(a2a) == 3, a2a
    # a decode step regroups the activation: its rows are the rank's B / 2
    # tokens, its columns 2 heads' z, all of x, B and C (the conv ring
    # keeps every channel) and 2 dt; then conv_w and conv_b
    dec = got["ssm_decode"]
    cols = 2 * 16 + d_in + 2 * 16 + 2
    a2a = [n for kind, n in dec["coll"] if kind == "all-to-all"]
    assert a2a[0] == B // 2 * cols * 4 and len(a2a) == 3, a2a
    gathers = [n for kind, n in dec["coll"] if kind == "all-gather"]
    assert not gathers or max(gathers) < whole, (gathers, whole)
    assert dec["out"] == ["Shard(dim=0)", "Partial(sum)"], dec["out"]
    assert dec["ssd"] == ["Shard(dim=0)", "Shard(dim=1)"], dec["ssd"]


DECODE = r"""
import dataclasses, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M, ssm

STEPS, B, S = 3, 4, 32
mode, out = sys.argv[1], sys.argv[2]
cfg = get_smoke_config("mamba2-370m")
cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=2))
p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.float32)
rng = np.random.default_rng(1)
us = [torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model)).astype(
    np.float32)) for _ in range(STEPS)]
x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(
    np.float32))
cache = M.init_cache(cfg, B, 8, device="cpu")
state = {k: v[0] for k, v in cache["ssm"].items()}
if mode == "mesh":
    import torch.distributed as dist
    rank, world, store = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as SH
    mesh = make_host_mesh(4, device="cpu")
    policy = SH.ShardingPolicy()
    p = SH.distribute({f"ssm_layers.0.ssm.{k}": v for k, v in p.items()},
                      mesh, policy)
    p = M.cast_weights({k.split(".")[-1]: v for k, v in p.items()},
                       torch.float32)
    shapes = M.map_specs(M.cache_specs(cfg, B, 8), lambda s, d: torch.empty(s))
    cache = SH.distribute_by_specs(cache, SH.cache_specs(policy, mesh, shapes),
                                   mesh)
    state = {k: v[0] for k, v in cache["ssm"].items()}
    want = {k: str(tuple(v.placements)) for k, v in state.items()}
    us = [SH.distribute_leaf(u, mesh, SH.placements((), mesh)) for u in us]
    x = SH.distribute_leaf(x, mesh, SH.placements((), mesh))
ys = []
with torch.no_grad():
    assert (ssm.head_parallel_plan(cfg, p) is None) == (mode != "mesh")
    prefill = ssm.ssm_apply(p, cfg, x)
    if mode == "mesh":
        prefill = prefill.full_tensor()
    for u in us:
        y, state = ssm.ssm_decode(p, cfg, u, state)
        if mode == "mesh":
            got = {k: str(tuple(v.placements)) for k, v in state.items()}
            assert got == want, (got, want)
            y = y.full_tensor()
        ys.append(y)
if mode == "mesh":
    state = {k: v.full_tensor() for k, v in state.items()}
    if dist.get_rank() == 0:
        print("placements", want["ssd"], want["conv"], flush=True)
if mode != "mesh" or dist.get_rank() == 0:
    np.savez(out, y=torch.stack(ys).numpy(), ssd=state["ssd"].numpy(),
             prefill=prefill.numpy(),
             conv=state["conv"].numpy(), placed=np.array(
                 [want["ssd"], want["conv"]] if mode == "mesh" else []))
if mode == "mesh":
    dist.destroy_process_group()
"""


def test_ssm_decode_keeps_the_state_on_cache_specs(tmp_path):
    """Also the head-parallel prefill, both with 2 groups of B and C."""
    plain, mesh = str(tmp_path / "plain.npz"), str(tmp_path / "mesh.npz")
    run_ranks(DECODE, ["plain", plain], 1, "", TIMEOUT_S)
    run_ranks(DECODE, ["mesh", mesh], 4, str(tmp_path / "store"), TIMEOUT_S)
    want, got = dict(np.load(plain)), dict(np.load(mesh))
    ssd_pl, conv_pl = got.pop("placed")
    # rows on the one-rank data axis, heads (the ring whole) on model
    assert ssd_pl == "(Shard(dim=0), Shard(dim=1))"
    assert conv_pl == "(Shard(dim=0), Replicate())"
    for key in ("prefill", "y", "ssd", "conv"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
