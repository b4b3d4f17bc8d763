"""Prefill and decode on a mesh of 4 gloo CPU processes against the one-
process path, at float32.

The one-process path is the one held against the reference
(``tests/test_torch_serve.py``, ``tests/test_torch_lm.py``); this file
holds the mesh path to it.  Per case, one subprocess runs the one-process
path and 4 rank processes (rendezvousing through a ``FileStore`` under
``tmp_path``, no TCP port) run the mesh path, each:

* a 4 x 32 prefill through ``launch.steps.make_prefill_step`` from the
  seed-0 weights, laid out by the sharding rules (the attention through
  ``flash_attention`` on each rank's heads, the GQA kv heads sliced by
  rank where they cannot shard; whisper's encoder and cross-attention,
  qwen2-vl's M-RoPE, the SSM scan on each rank's rows and, where the
  model axis divides them, its own heads, the MoE dispatch on each rank's
  rows and its own experts);
* ``launch.serve.lm_decode``, the LM mode of ``serve``: 6 greedy steps of
  4 slots on a 64-entry cache laid out by ``cache_specs`` (kv heads
  sliced from a sharded cache, the SSM state stepped on each rank's rows
  and heads, the new entries copied into the sharded caches).

Prefill and decode logits must agree within 1e-5, and the tokens must be
equal.  qwen3-1.7b smoke runs on (2, 2) (its 2 kv heads on the 2-way
model axis) and on (1, 4) (the 4 q heads sharded, the kv heads and the
cache's heads replicated); the other families on (2, 2); olmoe-1b-7b
(4 experts, one a rank) and mamba2-370m (8 heads, two a rank) also on
(1, 4), where the expert-parallel MoE and the head-parallel SSM block
(its projections regrouped to each rank's heads by an all-to-all) run
with no data axis to share the work.
"""

import numpy as np
import pytest

from torch_port_util import run_ranks

CASE = r"""
import argparse, dataclasses, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch import steps as S

SLOTS, CACHE, STEPS, B, SEQ = 4, 64, 6, 4, 32
arch, mode, out, model_parallel = sys.argv[1:5]
cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
rng = np.random.default_rng(0)
batch = {"tokens": torch.from_numpy(
    rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32))}
if cfg.vision_tokens > 0:
    batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
        (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
if cfg.enc_dec:
    batch["frames"] = torch.from_numpy(rng.standard_normal(
        (B, cfg.enc_frames, cfg.d_model)).astype(np.float32))
mesh = None
if mode == "mesh":
    import torch.distributed as dist
    rank, world, store = int(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.ctx import activation_sharding
    mesh = make_host_mesh(int(model_parallel), device="cpu")
args = argparse.Namespace(arch=arch, full=False, slots=SLOTS,
                          cache_len=CACHE, steps=STEPS, device="cpu",
                          model_parallel=(int(model_parallel) if mesh
                                          else None))
dec = serve.lm_decode(args, cfg=cfg)
assert (dec["mesh"] is not None) == (mesh is not None)
model = S.init_params(cfg, seed=0, device="cpu")
prefill = S.make_prefill_step(cfg)
with torch.no_grad():
    if mesh is None:
        logits = prefill(model, batch)
    else:
        policy = SH.ShardingPolicy()
        params = SH.distribute({n: p.detach() for n, p in
                                model.named_parameters()}, mesh, policy)
        model = M.LM(cfg, M.param_tree(cfg, params))
        batch = SH.distribute_by_specs(
            batch, SH.batch_specs(policy, mesh, batch), mesh)
        with activation_sharding(mesh, SH.activation_rules(policy)):
            logits = prefill(model, batch).full_tensor()
if mesh is None or dist.get_rank() == 0:
    np.savez(out, prefill=logits.numpy(),
             decode=torch.stack(dec["logits"]).numpy(),
             tokens=dec["tokens"].numpy())
if mesh is not None:
    dist.destroy_process_group()
"""

WORLD = 4
TIMEOUT_S = 240
CASES = [("qwen3-1.7b", 2), ("qwen3-1.7b", 4), ("olmoe-1b-7b", 2),
         ("zamba2-2.7b", 2), ("whisper-medium", 2), ("qwen2-vl-2b", 2),
         ("olmoe-1b-7b", 4), ("mamba2-370m", 4)]


@pytest.mark.parametrize("arch,model_parallel", CASES)
def test_mesh_prefill_and_decode_equal_one_process(tmp_path, arch,
                                                    model_parallel):
    plain_out, mesh_out = str(tmp_path / "plain.npz"), str(
        tmp_path / "mesh.npz")
    run_ranks(CASE, [arch, "plain", plain_out, 1], 1, "", TIMEOUT_S)
    run_ranks(CASE, [arch, "mesh", mesh_out, model_parallel], WORLD,
              str(tmp_path / "store"), TIMEOUT_S)
    want, got = dict(np.load(plain_out)), dict(np.load(mesh_out))
    for key in ("prefill", "decode"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
    assert (got["tokens"] == want["tokens"]).all()
