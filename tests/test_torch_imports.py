"""The PyTorch port stands alone: no jax, nothing of the JAX package, and no
silent fall back to the CPU when the GPU is missing."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'src' / 'repro_torch'
IMPORT_RE = re.compile(r'^\s*(from|import)\s+(repro|jax)(\.|\s|$)', re.M)

GUARD = r'''
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))
print(len(names), bad)
'''


def test_every_module_imports_without_jax_or_the_reference():
    """A fresh interpreter (xdist workers already hold jax) imports every
    module of the port and ``chip_smoke.py``: neither jax nor ``repro``
    may end up in ``sys.modules``."""
    code = GUARD.format(src=str(ROOT / 'src'), root=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(' ', 1)
    assert int(n) >= 30, res.stdout          # every module was found
    assert bad.strip() == '[]', bad


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip())
            for f in files for m in IMPORT_RE.finditer(f.read_text())]
    assert hits == []


def test_no_cuda_means_no_node(monkeypatch):
    """Entry points run on the GPU unless the caller asks for the CPU; with
    no GPU and no ``device='cpu'`` they raise instead of carrying on."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.node import NodeOrchestrator
    from repro_torch.launch.serve import build_node, serve_demo
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_node()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve_demo(steps=1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device('cuda')
    cfg = reduced(get_config('qwen3-0.6b'), page_size=4)
    model = build_model(cfg)
    params = model.init_params(0, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Engine(model, params, KVPool(4, 2, page_size=4), EngineConfig())
    node = build_node(device='cpu')          # asked for by name: fine
    assert node.online.device == torch.device('cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        node.add_engine(cfg, EngineConfig(klass='offline'))
    assert isinstance(node, NodeOrchestrator)
