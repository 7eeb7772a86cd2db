"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never move to the CPU on their own."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_port_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_runs_with_jax_blocked():
    """Import every module of the port and run a tiny CPU prefill and decode
    step in a process where ``import jax`` and ``import repro`` fail."""
    code = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import importlib, pkgutil
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import torch
from repro_torch.configs import get_config, scaled_down
from repro_torch.models import model as M
cfg = scaled_down(get_config("smollm-360m"), n_heads=6, n_kv_heads=2)
params = M.init_params(cfg, 0, device="cpu")
lg, st = M.prefill(cfg, params, torch.tensor([[1, 2, 3]]), 8)
lg, st = M.decode_step(cfg, params, lg.argmax(-1), st)
assert lg.shape == (1, cfg.padded_vocab) and bool(torch.isfinite(lg).all())
assert not any(k.split(".")[0] in ("jax", "repro") and v is not None
               for k, v in sys.modules.items())
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_without_device_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run on it")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine
    cfg = scaled_down(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg, 0)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, batch_slots=1, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "smollm-360m", "--requests", "1"])


def test_serve_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    fins = serve.main(["--arch", "smollm-360m", "--requests", "3",
                       "--slots", "2", "--max-new", "3", "--device", "cpu"])
    assert sorted(f.uid for f in fins) == [0, 1, 2]
    assert all(len(f.tokens) == 3 for f in fins)
    assert "served 3 requests" in capsys.readouterr().out
