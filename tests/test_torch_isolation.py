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


def test_the_serving_and_analysis_modules_are_in_scope():
    """The serving runtime and the analysis tiers are held to the same
    rule as the rest of the port."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("serving/__init__.py", "serving/batcher.py",
                   "serving/ingress.py", "serving/registry.py",
                   "serving/runtime.py", "analysis/specs.py",
                   "analysis/memory.py", "analysis/roofline.py",
                   "analysis/effects.py", "analysis/hazards.py",
                   "analysis/serving.py", "analysis/examples.py",
                   "ops/meta.py"):
        assert f"keystone_tpu_torch/{module}" in names, module


def test_serving_runtime_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from keystone_tpu_torch.serving import ServingRuntime

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingRuntime(object(), element_shape=(4,))
    from keystone_tpu_torch.serving.swap_check import swap_check

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        swap_check(swaps=1, n_train=60, n_test=30, filters=4)


def test_the_plan_tier_and_out_of_core_modules_are_in_scope():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("analysis/precision.py", "analysis/planner.py",
                   "analysis/plan_ir.py", "loaders/ooc_loader.py",
                   "pipelines/__main__.py", "data/dataset.py",
                   "utils/batching.py", "workflow/optimizer.py"):
        assert f"keystone_tpu_torch/{module}" in names, module


def test_out_of_core_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import numpy as np

    from keystone_tpu_torch.data.dataset import (
        OutOfCoreDataset,
        SpilledDataset,
    )
    from keystone_tpu_torch.loaders import (
        out_of_core_from_shards,
        synthetic_out_of_core,
    )

    rows = np.zeros((4, 2), np.float32)
    for make in (lambda: synthetic_out_of_core(8, 2),
                 lambda: out_of_core_from_shards([lambda: rows], [4]),
                 lambda: OutOfCoreDataset([lambda: rows], [4]),
                 lambda: SpilledDataset(rows)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_the_measurement_tier_modules_are_in_scope():
    """The bench modules, the reconciliation, the contract auditor and
    the analysis CLI are held to the same rule as the rest of the port."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("dispatch_bench.py", "compile_bench.py",
                   "analysis/reconcile.py", "analysis/contracts.py",
                   "analysis/__main__.py"):
        assert f"keystone_tpu_torch/{module}" in names, module


@pytest.mark.parametrize("call", [
    "dispatch_measure", "dispatch_report", "compile_example",
    "compile_host_chunk", "compile_report", "analysis_cli",
    "dispatch_cli"])
def test_measurement_entry_points_ask_for_the_card(call):
    """The entry points that take ``device`` default to the card and
    raise without one; the analysis CLI's ``--device`` too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from keystone_tpu_torch import compile_bench, dispatch_bench
    from keystone_tpu_torch.analysis import __main__ as analysis_cli

    calls = {
        "dispatch_measure": lambda: dispatch_bench.measure_example(
            "LinearPixels", "megafused"),
        "dispatch_report": lambda: dispatch_bench.dispatch_count_report(
            ("LinearPixels",)),
        "compile_example": lambda: compile_bench.measure_example_compiles(
            "LinearPixels"),
        "compile_host_chunk": compile_bench.measure_host_chunk_compiles,
        "compile_report": lambda: compile_bench.compile_count_report(
            ("LinearPixels",)),
        "analysis_cli": lambda: analysis_cli.main(
            ["--explain-roofline", "LinearPixels"]),
        "dispatch_cli": lambda: dispatch_bench.main(["LinearPixels"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()


def test_the_model_axis_and_sharding_modules_are_in_scope():
    """The sharding tier and the parallel layer, extended with the model
    axis, are held to the same rule as the rest of the port."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("analysis/sharding.py", "analysis/planner.py",
                   "parallel/__init__.py", "parallel/mesh.py",
                   "parallel/collectives.py", "parallel/multihost.py"):
        assert f"keystone_tpu_torch/{module}" in names, module


def test_the_sharding_tier_and_plan_sharding_load_no_jax():
    """`analysis/sharding.py`'s passes and `plan_sharding` on a 2x4
    layout run without JAX or the JAX package in the process."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from keystone_tpu_torch.analysis import SpecDataset\n"
        "from keystone_tpu_torch.analysis.planner import plan_sharding\n"
        "from keystone_tpu_torch.analysis.propagate import spec_pass\n"
        "from keystone_tpu_torch.analysis.sharding import sharding_pass\n"
        "from keystone_tpu_torch.nodes.stats import RandomSignNode\n"
        "applied = RandomSignNode(16, device='cpu').to_pipeline().apply(\n"
        "    SpecDataset((16,), np.float32, count=64))\n"
        "specs, _ = spec_pass(applied.graph, {})\n"
        "layout = {'data': 2, 'model': 4}\n"
        "sharding_pass(applied.graph, specs, mesh=layout)\n"
        "plan_sharding(applied.graph, specs, mesh=layout)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'keystone_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_model_axis_entry_points_ask_for_the_card():
    """A gloo group over the card's tensors needs a card, as NCCL does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from keystone_tpu_torch.parallel import init_multihost

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_multihost("127.0.0.1:1", 2, 0, backend="gloo")


def test_the_data_axis_estimator_modules_are_in_scope():
    """The estimators, evaluators and pipelines that fit across ranks
    since the image side of the data axis are held to the same rule."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("nodes/learning/kernels.py", "nodes/learning/pca.py",
                   "nodes/learning/kmeans.py", "nodes/learning/gmm.py",
                   "nodes/learning/weighted_ls.py",
                   "nodes/images/fisher_vector.py",
                   "evaluation/augmented.py", "evaluation/map_evaluator.py",
                   "pipelines/cifar_variants.py",
                   "pipelines/voc_sift_fisher.py",
                   "pipelines/imagenet_sift_lcs_fv.py"):
        assert f"keystone_tpu_torch/{module}" in names, module


def test_the_row_gathers_load_no_jax():
    """`gather_rows`, `collect_rows` and a `HostDataset` placed on no
    mesh run without JAX or the JAX package in the process."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "from keystone_tpu_torch.data.dataset import HostDataset\n"
        "from keystone_tpu_torch.nodes.learning.pca import collect_rows\n"
        "from keystone_tpu_torch.parallel import gather_rows\n"
        "x = torch.arange(12.0).reshape(6, 2)\n"
        "assert gather_rows(x, [5, 0, 5], None).tolist() == \\\n"
        "    [[10.0, 11.0], [0.0, 1.0], [10.0, 11.0]]\n"
        "items = [np.ones((2, 3), np.float32), np.zeros((1, 3), np.float32)]\n"
        "ds = HostDataset.on_mesh(items, None, device='cpu')\n"
        "assert ds.mesh is None and collect_rows(ds).shape == (3, 3)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'keystone_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("pipeline", ["kernel", "augmented",
                                      "augmented_kernel", "voc",
                                      "imagenet"])
def test_the_data_axis_pipelines_ask_for_the_card(pipeline):
    """The pipelines that take the current mesh default to the card and
    raise without one, mesh or not."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from keystone_tpu_torch.pipelines import cifar_variants as cv
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
    from keystone_tpu_torch.pipelines import voc_sift_fisher as voc

    calls = {
        "kernel": lambda: cv.run_random_patch_cifar_kernel(
            cv.RandomPatchCifarKernelConfig(synth_train=8, synth_test=4)),
        "augmented": lambda: cv.run_random_patch_cifar_augmented(
            cv.RandomPatchCifarAugmentedConfig(synth_train=8, synth_test=4)),
        "augmented_kernel": lambda: cv.run_random_patch_cifar_augmented_kernel(
            cv.RandomPatchCifarAugmentedKernelConfig(synth_train=8,
                                                     synth_test=4)),
        "voc": lambda: voc.run(voc.VOCSIFTFisherConfig(n_synth=6,
                                                       num_classes=3)),
        "imagenet": lambda: imagenet.run(
            imagenet.ImageNetSiftLcsFVConfig(n_synth=6)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[pipeline]()
