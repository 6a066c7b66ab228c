"""Guards on the port: what it imports, where it runs by default, what import builds."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from unet_embroidery_seg_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "unet_embroidery_seg_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "unet_embroidery_seg_tpu"}
# The port's package, its scripts, chip_smoke.py and the test module it runs on the card.
PORT_FILES = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "scripts").glob("torch_*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_alternates.py"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    assert path.exists()
    assert not (_imported_roots(path) & FORBIDDEN)


def test_chip_smoke_imports_no_image_library():
    assert not (_imported_roots(ROOT / "chip_smoke.py") & {"PIL", "cv2"})


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_build_model_defaults_to_cuda():
    from unet_embroidery_seg_torch.models import build_model

    if torch.cuda.is_available():
        assert next(build_model("unet_resnet50", 2).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model("unet_resnet50", 2)


def test_package_imports_without_nvcc_and_builds_nothing():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, shutil, sys\n"
        "assert shutil.which('nvcc') is None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from unet_embroidery_seg_torch.ops import _build\n"
        "assert _build._libs == {}, _build._libs\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
