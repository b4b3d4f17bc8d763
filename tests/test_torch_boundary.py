"""The port's boundary: no JAX, no ``repro``, and the card by default.

* every ``repro_torch`` module imports in a process whose import system
  refuses ``jax`` and ``repro``, and so does ``chip_smoke.py``'s text;
* without a GPU, or outside a checkout, ``chip_smoke.py`` exits non-zero
  and prints no result;
* the entry points default to ``cuda`` and, without a card, raise an
  error that names ``device="cpu"``; a kernel wrapper given a tensor on
  neither device raises instead of running a plain version.

No output codes are compared here (the other ``test_torch_*`` files hold
them to a tolerance of 0).
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from torch_port_util import ARTIFACT, ROOT, SRC, random_stack

from repro_torch import engine, resolve_device
from repro_torch.configs import fpga4hep, get_smoke_config
from repro_torch.core import logicnet as LN
from repro_torch.core.train import train_logicnet
from repro_torch.kernels import lut_network as P
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lut_lookup import lut_lookup
from repro_torch.kernels.masked_matmul import masked_matmul
from repro_torch.launch import steps
from repro_torch.models import model as M

PORT = pathlib.Path(SRC) / "repro_torch"

_BLOCKING_IMPORT = """
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print("IMPORTED", len(names))
"""


def _env():
    return dict(os.environ, PYTHONPATH=SRC)


def test_every_module_imports_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _BLOCKING_IMPORT],
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n == len(list(PORT.rglob("*.py")))


def test_no_source_names_jax_or_repro_imports():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [pathlib.Path(ROOT, "chip_smoke.py")]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    runs = [(ROOT, os.path.join(ROOT, "chip_smoke.py"))]
    alone = shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    runs.append((str(tmp_path), alone))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
        assert "FAIL" in proc.stderr


def test_default_device_is_cuda():
    layers = random_stack((8, 6), (2,), (2,))
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert engine.load(ARTIFACT).device.type == "cuda"
        return
    cfg = fpga4hep.model_a()
    for call in (resolve_device, lambda: engine.load(ARTIFACT),
                 lambda: engine.compile_network(layers),
                 lambda: P.build_network_slabs(layers),
                 lambda: LN.init(cfg, torch.Generator()),
                 lambda: train_logicnet(cfg, None, None, None, None)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
         "--artifact", ARTIFACT, "--smoke"], env=_env(),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and 'device="cpu"' in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_jsc_logicnet",
         "--steps", "1"], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and 'device="cpu"' in proc.stderr
    cfg = get_smoke_config("qwen3-1.7b")
    for call in (lambda: steps.init_params(cfg),
                 lambda: M.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
         "qwen3-1.7b", "--requests", "1"], env=_env(), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and 'device="cpu"' in proc.stderr
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA device raises: the plain
    versions run only for CPU tensors."""
    idx, tab, bw = random_stack((8, 6), (2,), (2,))[0]
    meta = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lut_lookup(meta, torch.from_numpy(idx), torch.from_numpy(tab), bw)
    us = P.build_network_slabs([(idx, tab, bw)], device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        P.lut_network(meta, us)
    ms = engine.load(ARTIFACT, device="cpu").slabs
    with pytest.raises(ValueError, match="cuda or cpu"):
        P.lut_network_mixed(torch.empty((4, 16), dtype=torch.int32,
                                        device="meta"), ms)
    with pytest.raises(ValueError, match="cuda or cpu"):
        masked_matmul(*(torch.empty((4, 4), device="meta")
                        for _ in range(3)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(*(torch.empty((1, 2, 4, 8), device="meta")
                          for _ in range(3)))
    launches = (lut_lookup.launches, P.lut_network.launches,
                P.lut_network_mixed.launches, masked_matmul.launches,
                flash_attention.launches)
    x = torch.zeros((2, 8), dtype=torch.int32)
    assert P.lut_network(x, us).shape == (2, 6)
    assert lut_lookup(x, torch.from_numpy(idx), torch.from_numpy(tab),
                      bw).shape == (2, 6)
    assert masked_matmul(torch.ones(2, 3), torch.ones(3, 4),
                         torch.ones(3, 4)).shape == (2, 4)
    assert flash_attention(*(torch.ones(1, 2, 4, 8)
                             for _ in range(3))).shape == (1, 2, 4, 8)
    # the plain versions are not kernel launches
    assert launches == (lut_lookup.launches, P.lut_network.launches,
                        P.lut_network_mixed.launches, masked_matmul.launches,
                        flash_attention.launches)
