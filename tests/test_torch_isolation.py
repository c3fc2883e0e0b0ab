"""The port stands alone: no JAX, no `keystone_tpu`, no silent CPU.

`keystone_tpu_torch` and `chip_smoke.py` must import neither `jax` nor
anything of the JAX package (which imports JAX), and an entry point asked
for the card when there is none must raise rather than run on the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "keystone_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "keystone_tpu" or module.startswith("keystone_tpu."))


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    assert path.exists()
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import keystone_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'keystone_tpu' or m.startswith('keystone_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_a_card(tmp_path):
    """Called without ``device="cpu"``, the entry points ask for the card;
    with no card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import numpy as np

    from keystone_tpu_torch.nodes.util.basic import MaxClassifier
    from keystone_tpu_torch.workflow import FittedPipeline

    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.device import resolve_device
    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        run,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Dataset(np.zeros((4, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_cifar(8, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(RandomPatchCifarConfig(synth_train=8, synth_test=4))
    path = str(tmp_path / "fitted.pkl")
    MaxClassifier().to_pipeline().fit().save(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FittedPipeline.load(path)
    assert resolve_device("cpu") == torch.device("cpu")
    assert isinstance(FittedPipeline.load(path, device="cpu"), FittedPipeline)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_loads_no_jax_native_library(path):
    """The port decodes images with its own sources (`csrc/`): no port
    module, and not `chip_smoke.py`, names the JAX package's
    `native/libkeystone_io.so` or its `native_io` bindings."""
    text = path.read_text()
    assert "libkeystone_io" not in text
    assert "keystone_tpu.utils.native_io" not in text
    assert "keystone_tpu.utils import native_io" not in text


def test_port_telemetry_loads_nothing_of_jax_s():
    code = (
        "import sys\n"
        "import keystone_tpu_torch.telemetry\n"
        "import keystone_tpu_torch.telemetry.__main__\n"
        "import keystone_tpu_torch.utils.native_io\n"
        "import keystone_tpu_torch.loaders.image_loaders\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'keystone_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
