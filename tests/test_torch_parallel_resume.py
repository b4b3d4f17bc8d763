"""Checkpoints of a mesh run, and ``--resume`` onto a fresh mesh, through
``launch.train.build``.

Three runs of 4 gloo CPU processes on a (2, 2) mesh (``--model-parallel
2 --grad-rs``, qwen3-1.7b smoke with the LogicNet-FFN, 4 steps of the
cosine schedule), each a set of processes of its own rendezvousing
through a ``FileStore`` under ``tmp_path``:

* ``full``: 4 steps, no checkpoint;
* ``save``: 2 steps and a checkpoint at step 2, each rank given a
  directory of its own: every rank gathers the DTensors whole and rank 0
  alone writes;
* ``resume``: ``--resume`` from rank 0's directory in new processes, the
  state laid out by the rules as it is read (``try_restore(map_fn=)``),
  then steps 3 and 4.

The losses of ``save`` then ``resume`` and the final parameters must
equal ``full``'s bit for bit, as the one-process save-and-resume tests
hold them.
"""

import os

import numpy as np
import pytest

from torch_port_util import run_ranks

CASE = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
mode, base = sys.argv[1], sys.argv[2]
rank, world, store = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.launch import train
ckpt = {"full": os.path.join(base, f"full_{rank}"),
        "save": os.path.join(base, f"save_{rank}"),
        "resume": os.path.join(base, "save_0")}[mode]
flags = ["--logicnet-ffn", "--model-parallel", "2", "--grad-rs",
         "--device", "cpu", "--steps", "4", "--seq", "32",
         "--global-batch", "8", "--ckpt-dir", ckpt,
         "--ckpt-every", "2" if mode == "save" else "1000"]
if mode == "resume":
    flags.append("--resume")
run = train.build(train.parse_args(flags))
assert run.mesh is not None and run.mesh.size() == world
start = run.loop.step
run.loop.run(run.batches, 2 if mode == "save" else 4)
params = {k: v.detach().full_tensor().numpy()
          for k, v in run.loop.state["params"].items()}
placed = str(tuple(run.loop.state["params"]["layers.0.attn.wq"].placements))
if rank == 0:
    np.savez(os.path.join(base, f"{mode}.npz"), start=start,
             losses=np.array([l for _, l in run.loop.metrics]),
             placed=placed, **params)
dist.destroy_process_group()
"""

WORLD = 4
TIMEOUT_S = 240


def _run(base, mode: str) -> dict:
    run_ranks(CASE, [mode, str(base)], WORLD, str(base / f"store_{mode}"),
              TIMEOUT_S)
    return dict(np.load(base / f"{mode}.npz"))


def test_mesh_resume_equals_an_uninterrupted_run(tmp_path):
    full = _run(tmp_path, "full")
    saved = _run(tmp_path, "save")
    files = {r: sorted(os.listdir(tmp_path / f"save_{r}"))
             if (tmp_path / f"save_{r}").is_dir() else []
             for r in range(WORLD)}
    assert files[0] == ["step_00000002.npz"], files
    assert all(not f for r, f in files.items() if r), files
    resumed = _run(tmp_path, "resume")
    assert int(resumed.pop("start")) == 2
    for got in (full, saved, resumed):
        assert str(got.pop("placed")) == "(Shard(dim=0), Shard(dim=1))"
    assert len(full["losses"]) == 4 and len(saved["losses"]) == 2
    assert (np.concatenate([saved.pop("losses"), resumed.pop("losses")])
            .tolist() == full.pop("losses").tolist())
    full.pop("start")
    assert sorted(resumed) == sorted(full)
    for name, want in full.items():
        assert (resumed[name] == want).all(), name


def test_path_keys_invert_the_checkpoint_paths():
    """``ckpt.path_keys`` (what ``--resume`` on a mesh names each restored
    leaf by) gives back every key that ``ckpt._leaves`` wrote into a
    train state's paths, and refuses a path of another form."""
    from repro_torch.checkpoint import ckpt
    tree = {"state": {"params": {"layers.0.attn.wq": 1, "embed.tok": 2},
                      "opt": {"m": {"layers.0.attn.wq": 3}, "step": 4}},
            "step": 5, "seq": [6, [7]]}
    got = {".".join(ckpt.path_keys(p)): leaf
           for p, leaf in ckpt._leaves(tree)}
    assert got == {"state.params.layers.0.attn.wq": 1,
                   "state.params.embed.tok": 2,
                   "state.opt.m.layers.0.attn.wq": 3, "state.opt.step": 4,
                   "step": 5, "seq.0": 6, "seq.1.0": 7}
    for bad in ("['a']x", "state.params", "['a'"):
        with pytest.raises(ValueError):
            ckpt.path_keys(bad)
