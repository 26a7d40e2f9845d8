"""The port stands alone: no module of ``edl_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax or the JAX package, and its
entry points refuse to run silently on the CPU when CUDA is absent."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "edl_tpu_torch")
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax")


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN_ROOTS or name == "edl_tpu" \
        or name.startswith("edl_tpu.")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_static_scan_finds_no_forbidden_import():
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += ["%s: %s" % (os.path.relpath(path, REPO), n)
                      for n in names if _forbidden(n)]
    assert not found, found


def test_importing_every_module_loads_no_jax():
    code = r"""
import importlib, os, pkgutil, sys
import edl_tpu_torch
for m in pkgutil.walk_packages(edl_tpu_torch.__path__, "edl_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or n == "edl_tpu" or n.startswith("edl_tpu."))
print("MODULES", len([n for n in sys.modules
                      if n.startswith("edl_tpu_torch")]))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("MODULES")[1].split()[0]) >= 20


def test_entry_points_raise_without_cuda(monkeypatch):
    from edl_tpu_torch.distill import teacher_server
    from edl_tpu_torch.models import gpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teacher_server.gpt_teacher()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.Gpt(num_layers=1, d_model=8, num_heads=1, mlp_dim=8,
                vocab_size=8, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teacher_server.gpt_teacher(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teacher_server.lm_teacher()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teacher_server.lm_teacher(device="cuda")
    # the training entry points: the bench's LM loop and its models
    from edl_tpu_torch import bench
    from edl_tpu_torch.models import bert
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_gpt(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bert(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.bert_tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.create_model_and_loss()
