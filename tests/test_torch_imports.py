"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

- every module of ``sutro_tpu_torch``, and ``chip_smoke``, imports in a
  fresh interpreter where importing ``jax`` or ``sutro_tpu`` fails;
- an AST scan finds no import of either in any file of the port;
- ``chip_smoke.main()`` exits non-zero and prints no result without a
  CUDA device.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sutro_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sutro_tpu")
# the kernel modules and the modules around them, imported by name
MODULES = (
    "sutro_tpu_torch.ops.cuda_build",
    "sutro_tpu_torch.ops.paged_decode",
    "sutro_tpu_torch.ops.kv_write",
    "sutro_tpu_torch.ops.flash_prefill",
    "sutro_tpu_torch.ops.prefix_carry",
    "sutro_tpu_torch.ops.grouped_matmul",
    "sutro_tpu_torch.ops.moe",
    "sutro_tpu_torch.ops.attention",
    "sutro_tpu_torch.models.transformer",
    "sutro_tpu_torch.engine.runner",
    "sutro_tpu_torch.engine.scheduler",
    "sutro_tpu_torch.engine.weights",
    "sutro_tpu_torch.engine.stepprofile",
)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'sutro_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import sutro_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "sutro_tpu_torch.__path__, 'sutro_tpu_torch.')]\n"
        f"names += [n for n in {MODULES!r} if n not in names]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in FORBIDDEN, f"{path}: imports {n}"


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
