"""The port stands alone: neither ``maskflownet_torch`` nor
``chip_smoke.py`` may reach JAX, the JAX package or the host libraries the
card's machine lacks, and its entry points refuse to run on the CPU unless
asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "optax", "maskflownet_tpu", "yaml", "PIL", "cv2")
PORT_FILES = sorted((ROOT / "maskflownet_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import_in_source(path):
    assert not _imported(path) & set(BANNED)


def test_importing_the_port_loads_no_banned_module():
    code = ("import sys, maskflownet_torch, maskflownet_torch.inference, "
            "maskflownet_torch.interop\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from maskflownet_torch import get_device
    from maskflownet_torch.inference import Predictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor({})
    assert get_device("cpu") == torch.device("cpu")
