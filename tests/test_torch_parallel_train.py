"""The train step on a mesh of 4 gloo CPU processes against the one-
process step, at float32.

Each run is a subprocess of its own (the 4 ranks rendezvous through a
``FileStore`` under ``tmp_path``, no TCP port; the one-process run starts
no process group), so no process group outlives a test.  The ranks lay
the seed-0 state out by the sharding rules (``parallel.sharding.
distribute``), take the same global batch sharded over ``data``, and run
2 AdamW steps of ``launch.steps.make_train_step``, with or without
``grad_shardings`` (``--grad-rs``).  Losses and final parameters
(gathered whole) must equal the one-process step's within 1e-5.  On
this mesh every kernel wrapper runs its plain version (CPU shards).

* qwen3-1.7b smoke with the LogicNet-FFN: the rules, ``local_map``'s
  placements in the masked matmul and the attention, and the GQA repair
  (its 2 kv heads against a 2-way model axis shard, or, on a (1, 4)
  mesh, stay replicated while the 4 q heads shard) on real data.
* The other families on (2, 2), the blocks that take their own road on
  a mesh: olmoe-1b-7b's MoE (``models.moe._moe_apply_mesh``: the
  router's statistics over the whole batch, each data rank dispatching
  its own token groups, the experts gathered whole), mamba2-370m's and
  zamba2-2.7b's SSM scan (``parallel.local.data_parallel``) and zamba2's
  shared attention block, whisper-medium's encoder and cross-attention,
  and qwen2-vl-2b's M-RoPE and vision rows.  Their parameters are held
  to 1e-5 but for the elements whose clipped first gradient is not 0 but
  below 1e-7: AdamW's first move of such an element, ``lr * g / (|g| +
  1e-8)``, follows g's own float32 rounding, which the sharded products'
  order of summation changes (zamba2's ``shared_attn.ffn.wo`` and
  whisper's ``enc_layers.1.ffn.wo`` each have one 1.6e-5 to 4.3e-5 apart
  after 2 steps).  Those are held to two first-step moves (6e-4), as
  ``chip_smoke.py`` phase 17a holds the same elements against the
  reference (``FT_EPS_CONDITIONED``).

The MoE's token groups are cut to 64 tokens in both runs
(``moe.GROUP_TOKENS``), so that each data rank's 128 tokens are whole
groups and the mesh run dispatches them on its own rank (at the default
1024, a 256-token batch is one group and every rank dispatches all of it).
"""

import numpy as np
import pytest

from torch_port_util import run_ranks

CASE = r"""
import dataclasses, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps as S
from repro_torch.models import moe
from repro_torch.models.config import LogicNetFFNCfg
from repro_torch.optim.adamw import AdamWCfg

STEPS, BATCH, SEQ = 2, 8, 32
moe.GROUP_TOKENS = 64
mode, out, arch, model = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
if arch == "qwen3-1.7b":
    cfg = dataclasses.replace(cfg, logicnet_ffn=LogicNetFFNCfg())
opt = AdamWCfg(lr=3e-4, weight_decay=0.01)
rng = np.random.default_rng(0)
batches = []
for _ in range(STEPS):
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    b = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
         "labels": torch.from_numpy(toks[:, 1:].copy())}
    if cfg.vision_tokens > 0:
        b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    batches.append(b)
state = S.make_train_state(cfg, seed=0, device="cpu")
if mode == "plain":
    from repro_torch.models import model as M
    from repro_torch.optim import global_norm
    params = state["params"]
    grads = torch.autograd.grad(M.loss_fn(params, cfg, batches[0]),
                                list(params.values()))
    scale = min(1.0, 1.0 / max(float(global_norm(grads)), 1e-12))
    cond = {f"cond:{n}": ((g != 0) & (g.abs() * scale < 1e-7)).numpy()
            for n, g in zip(params, grads)}
    step = S.make_train_step(cfg, opt)
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(float(loss))
    np.savez(out, losses=np.array(losses), **cond,
             **{k: v.detach().numpy() for k, v in state["params"].items()})
    sys.exit(0)

import torch.distributed as dist
rank, world, store = int(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.ctx import activation_sharding
mesh = make_host_mesh(int(model), device="cpu")
policy = SH.ShardingPolicy()
sh = SH.shardings_for_tree(state, mesh, policy)
state = SH.distribute(state, mesh, policy)
grad_sh = S.grad_shardings(sh) if mode == "grad_rs" else None
step = S.make_train_step(cfg, opt, grad_shardings=grad_sh)
losses = []
with activation_sharding(mesh, SH.activation_rules(policy)):
    for b in batches:
        b = SH.distribute_by_specs(b, SH.batch_specs(policy, mesh, b), mesh)
        state, loss = step(state, b)
        losses.append(float(loss))
params = {k: v.detach().full_tensor().numpy()
          for k, v in state["params"].items()}
placed = [str(tuple(state["params"][n].placements))
          for n in ("layers.0.attn.wq", "layers.0.attn.wk")
          if n in state["params"]]
if rank == 0:
    np.savez(out, losses=np.array(losses), placed=np.array(placed), **params)
dist.destroy_process_group()
"""

WORLD = 4
TIMEOUT_S = 240
QWEN3 = "qwen3-1.7b"
FAMILIES = ["olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b", "whisper-medium",
            "qwen2-vl-2b"]


def _run_plain(tmp_path, arch: str = QWEN3) -> dict:
    out = str(tmp_path / "plain.npz")
    run_ranks(CASE, ["plain", out, arch, 1], 1, "", TIMEOUT_S)
    return dict(np.load(out))


def _run_mesh(tmp_path, mode: str, model: int, world: int = WORLD,
              arch: str = QWEN3) -> dict:
    out = str(tmp_path / f"{mode}.npz")
    run_ranks(CASE, [mode, out, arch, model], world,
              str(tmp_path / f"store_{mode}"), TIMEOUT_S)
    return dict(np.load(out))


def _split(plain: dict) -> tuple[dict, dict]:
    """The one-process run's ``(parameters and losses, eps-conditioned
    masks)``."""
    cond = {k[len("cond:"):]: plain[k] for k in plain if k.startswith("cond:")}
    return {k: v for k, v in plain.items() if not k.startswith("cond:")}, cond


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _split(_run_plain(tmp_path_factory.mktemp("plain")))[0]


@pytest.mark.parametrize("mode,model", [("mesh", 2), ("grad_rs", 2),
                                        ("mesh", 4)])
def test_mesh_step_equals_one_process(plain, tmp_path, mode, model):
    """(2, 2): weights on both axes, the 2 kv heads on the model axis;
    (1, 4): 4 q heads on the model axis and the 2 kv heads replicated, so
    each rank slices the kv head its q head reads."""
    got = _run_mesh(tmp_path, mode, model)
    wq, wk = got.pop("placed")
    assert wq == "(Shard(dim=0), Shard(dim=1))"
    assert wk == ("(Shard(dim=0), Shard(dim=1))" if model == 2
                  else "(Shard(dim=0), Replicate())")
    np.testing.assert_allclose(got.pop("losses"), plain["losses"],
                               rtol=0, atol=1e-5)
    names = [k for k in plain if k != "losses"]
    assert sorted(names) == sorted(got)
    for name in names:
        np.testing.assert_allclose(got[name], plain[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_one_rank_mesh_gives_the_plain_bits(plain, tmp_path):
    """On a (1, 1) mesh every shard is the whole tensor and every
    collective is over one rank: the mesh path (``--grad-rs`` included)
    gives the one-process step's losses and parameters bit for bit."""
    got = _run_mesh(tmp_path, "grad_rs", 1, world=1)
    got.pop("placed")
    assert got.pop("losses").tolist() == plain["losses"].tolist()
    for name in (k for k in plain if k != "losses"):
        assert (got[name] == plain[name]).all(), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_mesh_step_equals_one_process(tmp_path, arch):
    want, cond = _split(_run_plain(tmp_path, arch))
    got = _run_mesh(tmp_path, "mesh", 2, arch=arch)
    got.pop("placed")
    np.testing.assert_allclose(got.pop("losses"), want.pop("losses"),
                               rtol=0, atol=1e-5)
    assert sorted(got) == sorted(want) == sorted(cond)
    for name, w in want.items():
        diff, c = np.abs(got[name] - w), cond[name]
        assert diff[~c].max(initial=0.0) <= 1e-5, name
        assert diff[c].max(initial=0.0) <= 2 * 3e-4, name
