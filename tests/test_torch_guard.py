"""Guards of the port's independence from JAX and from the reference.

* no file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro``;
* importing the engine leaves ``jax`` out of ``sys.modules``;
* without CUDA, entry points raise instead of running on the CPU, and
  ``chip_smoke.py`` exits non-zero with a clear message.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _run(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable] + code_or_args,
                          capture_output=True, text=True, timeout=120,
                          env=env, **kw)


def test_importing_the_engine_leaves_jax_out():
    r = _run(["-c", "import sys, repro_torch.serving.engine, "
              "repro_torch.launch.serve; "
              "print('jax' in sys.modules, 'repro' in sys.modules)"])
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False"]


def test_engine_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    from repro_torch.configs import get_tiny_config
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.weights import init_params
    cfg = get_tiny_config("tiny-100m")
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(cfg, params)
    with pytest.raises(ValueError, match="params live on cpu"):
        PagedEngine(cfg, params, device="meta")


def test_chip_smoke_fails_clearly_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = _run([str(ROOT / "chip_smoke.py")], cwd=tmp_path)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert '"ok"' not in r.stdout
