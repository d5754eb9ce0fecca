"""The port stands alone: neither ``maskflownet_torch`` nor
``chip_smoke.py`` may reach JAX, the JAX package or the host libraries the
card's machine lacks, and its entry points refuse to run on the CPU unless
asked to."""

import ast
import os
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


# the one optional dependency: ``infer --video`` imports OpenCV inside the
# function that needs it, and raises ImportError naming ``--frames``
# without it; nothing else may reach it
LAZY = {"maskflownet_torch/tools/infer.py": {"cv2"}}


def _imported_at_module_level(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import_in_source(path):
    lazy = LAZY.get(str(path.relative_to(ROOT)), set())
    assert not _imported(path) & (set(BANNED) - lazy)
    assert not _imported_at_module_level(path) & lazy


def test_importing_the_port_loads_no_banned_module():
    code = ("import sys, maskflownet_torch, maskflownet_torch.inference, "
            "maskflownet_torch.interop, maskflownet_torch.losses, "
            "maskflownet_torch.training, maskflownet_torch.augment, "
            "maskflownet_torch.config.presets, "
            "maskflownet_torch.ops.affine, maskflownet_torch.ops.deform, "
            "maskflownet_torch.ops.affine2pass, maskflownet_torch.native, "
            "maskflownet_torch.models.maskflownet, "
            "maskflownet_torch.tools.profile_infer, "
            "maskflownet_torch.tools.grad_parity, "
            "maskflownet_torch.tools.corr_ab, "
            "maskflownet_torch.tools.corr_trace, "
            "maskflownet_torch.data, maskflownet_torch.data.loader, "
            "maskflownet_torch.data.device_cache, "
            "maskflownet_torch.parallel, "
            "maskflownet_torch.parallel.mesh, "
            "maskflownet_torch.parallel.spatial, "
            "maskflownet_torch.tools.input_probe, "
            "maskflownet_torch.cli.main, maskflownet_torch.config, "
            "maskflownet_torch.data.sintel, maskflownet_torch.data.kitti, "
            "maskflownet_torch.data.hd1k, maskflownet_torch.data.things3d, "
            "maskflownet_torch.augment.host_geometry, "
            "maskflownet_torch.tools.submission, "
            "maskflownet_torch.tools.import_mxnet, "
            "maskflownet_torch.tools.infer, "
            "maskflownet_torch.tools.parity_eval\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_the_tools_package_does_not_load_its_command_line_modules():
    """``python -m maskflownet_torch.tools.infer`` (and the other tools)
    would warn if the package had already imported the module."""
    tools = ("import_mxnet", "infer", "parity_eval")
    code = ("import sys, maskflownet_torch.tools\n"
            f"print(sorted(m for m in {tools!r} if "
            "'maskflownet_torch.tools.' + m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout
    out = subprocess.run([sys.executable, "-W", "error::RuntimeWarning", "-m",
                          "maskflownet_torch.tools.infer", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "--frames" in out.stdout, out.stderr


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    from maskflownet_torch import get_device
    from maskflownet_torch.cli.main import main as cli_main
    from maskflownet_torch.data import DeviceBatchCache
    from maskflownet_torch.inference import Predictor
    from maskflownet_torch.parallel import DevicePrefetcher
    from maskflownet_torch.tools.infer import main as infer_main
    from maskflownet_torch.tools.parity_eval import main as parity_main
    from maskflownet_torch.training import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBatchCache(lambda: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher(lambda: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["MaskFlownet_S.yaml", "--root", str(tmp_path)])
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_main(["MaskFlownet_S.yaml", "-c", str(tmp_path / "ck.npz"),
                    "-i", "a.png", "b.png", "-o", out])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_main([str(tmp_path / "ck.npz"), "--sintel_root", out,
                     "--kitti_root", out])
    assert not os.listdir(tmp_path)
    assert get_device("cpu") == torch.device("cpu")
