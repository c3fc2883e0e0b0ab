"""MnistRandomFFT and TIMIT end to end, multi-epoch BCD, the CSV and TIMIT
loaders and the launcher: the port against the JAX package on the CPU.

Both packages draw every random weight and make every synthetic array
with numpy from the same seeds, and the port fits its own models. The
test scores must lie within 1e-4 of their largest magnitude of JAX's,
with the same argmax and so the same accuracy. MnistRandomFFT runs on
scikit-learn's digits at `tests/test_mnist_pipeline.py`'s configuration;
TIMIT on the synthetic stand-in at `tests/test_pipelines_e2e.py`'s.
BCD at three epochs carries its residual across epochs, so a fault that
grows with each epoch shows there: (W, b) within 1e-4 of max|W| of JAX's
`_bcd_fit_impl`.

The JAX pipelines run on a one-device mesh, the port's layout. On the
tests' 8-device CPU mesh (conftest.py) JAX's sharded BCD fit of the TIMIT
configuration lands 5.5e-4 of max|score| from a float64 fit of the same
features, where its one-device fit and the port's land within 2.5e-5.
"""

import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.loaders.csv_loader import (
    LabeledData as JaxLabeledData,
    csv_data_loader as jax_csv_data_loader,
)
from keystone_tpu.loaders.text_loaders import timit_loader as jax_timit_loader
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBCD,
)
from keystone_tpu.nodes.learning.block_ls import _bcd_fit
from keystone_tpu.nodes.stats import (
    CosineRandomFeatures as JaxCosine,
    LinearRectifier as JaxRectifier,
    PaddedFFT as JaxFFT,
    RandomSignNode as JaxSign,
)
from keystone_tpu.nodes.util import (
    Cacher as JaxCacher,
    ClassLabelIndicatorsFromInt as JaxIndicators,
    VectorCombiner as JaxCombiner,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.pipelines import mnist_random_fft as jax_mnist
from keystone_tpu.pipelines import timit as jax_timit
from keystone_tpu.workflow import Pipeline as JaxPipeline
from keystone_tpu_torch import __main__ as launcher
from keystone_tpu_torch.loaders.csv_loader import LabeledData, csv_data_loader
from keystone_tpu_torch.loaders.text_loaders import timit_loader
from keystone_tpu_torch.nodes.learning.block_ls import bcd_fit
from keystone_tpu_torch.nodes.stats import CosineRandomFeatures, RandomSignNode
from keystone_tpu_torch.nodes.util.fusion import (
    FusedBatchTransformer,
    _GatherConcatStage,
)
from keystone_tpu_torch.pipelines import mnist_random_fft as mnist
from keystone_tpu_torch.pipelines import timit
from keystone_tpu_torch.workflow.pipeline import Pipeline

REPO = pathlib.Path(__file__).resolve().parent.parent
SCORE_REL = 1e-4
MNIST_CFG = dict(num_ffts=4, block_size=512, lam=1e-3)
TIMIT_CFG = dict(num_cosines=512, n_synth=1500, synth_dim=128, num_classes=8)


def _jax_rows(ds):
    """A JAX dataset's rows, without the padding to the mesh's shards."""
    return np.asarray(ds.array)[:ds.count]


def _assert_same_scores(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SCORE_REL * float(np.abs(want).max()))


def _scorer(predictor):
    """``predictor`` with its sink moved off the final MaxClassifier."""
    g = predictor.graph
    argmax = g.get_sink_dependency(predictor.sink)
    g = g.set_sink_dependency(predictor.sink, g.get_dependencies(argmax)[0])
    return Pipeline(g, predictor.source, predictor.sink)


def _port_scores(predictor, data):
    """Every node but the final MaxClassifier."""
    return _scorer(predictor)(data).get().array.numpy()


@pytest.fixture
def one_device_mesh():
    with use_mesh(make_mesh(jax.devices()[:1])) as mesh:
        yield mesh


def test_mnist_random_fft_matches_jax_on_digits(one_device_mesh, monkeypatch):
    jcfg = jax_mnist.MnistRandomFFTConfig(**MNIST_CFG)
    cfg = mnist.MnistRandomFFTConfig(**MNIST_CFG)
    jtrain, jtest = jax_mnist._load(jcfg)
    train, test = mnist._load(cfg, "cpu")
    np.testing.assert_array_equal(train.data.numpy(), _jax_rows(jtrain.data))
    np.testing.assert_array_equal(test.labels.numpy(),
                                  _jax_rows(jtest.labels))
    dim = train.data.array.shape[1]
    branches = [JaxSign(dim, seed=jcfg.seed + i) >> JaxFFT()
                >> JaxRectifier(0.0) for i in range(jcfg.num_ffts)]
    labels = JaxIndicators(jcfg.num_classes)(jtrain.labels).get()
    scorer = (JaxPipeline.gather(branches) >> JaxCombiner()).and_then(
        JaxBCD(jcfg.block_size, num_iter=1, lam=jcfg.lam), jtrain.data,
        labels)
    want = _jax_rows(scorer(jtest.data).get())

    # every fused transformer the optimizer makes
    made = []
    real_init = FusedBatchTransformer.__init__

    def recording(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(FusedBatchTransformer, "__init__", recording)
    result = mnist.run_on(train, test, cfg)
    gathers = [f for f in made if isinstance(f.stages[0], _GatherConcatStage)]
    assert gathers and all(f.planned_kernel is None for f in made)
    # the gather pass's featurizer: the fit and the train predict share
    # one featurization (CSE), the test predict has its own; one 2048-row
    # microbatch each
    assert sum(f.microbatches_run for f in gathers) == 2
    got = _port_scores(result["predictor"], test.data)
    _assert_same_scores(got, want)
    want_acc = float(np.mean(want.argmax(1) == _jax_rows(jtest.labels)))
    assert result["test_accuracy"] == pytest.approx(want_acc, abs=1e-12)
    assert result["test_accuracy"] > 0.9
    assert result["seconds"] > 0.0


def test_timit_matches_jax_on_the_synthetic_frames(one_device_mesh):
    jcfg = jax_timit.TimitConfig(**TIMIT_CFG)
    cfg = timit.TimitConfig(**TIMIT_CFG)
    k = min(jcfg.num_classes, 12)
    jtrain = jax_timit._synthetic_timit(jcfg.n_synth, jcfg.synth_dim, k,
                                        jcfg.seed)
    jtest = jax_timit._synthetic_timit(jcfg.n_synth // 4, jcfg.synth_dim, k,
                                       jcfg.seed + 1)
    train, test, num_classes = timit.load(cfg, "cpu")
    assert num_classes == k
    np.testing.assert_array_equal(train.data.numpy(), _jax_rows(jtrain.data))
    np.testing.assert_array_equal(test.labels.numpy(),
                                  _jax_rows(jtest.labels))
    featurizer = JaxCosine(jcfg.synth_dim, jcfg.num_cosines, jcfg.gamma,
                           distribution=jcfg.distribution,
                           seed=jcfg.seed).to_pipeline() >> JaxCacher("t")
    labels = JaxIndicators(k)(jtrain.labels).get()
    scorer = featurizer.and_then(
        JaxBCD(jcfg.block_size, jcfg.num_epochs, jcfg.lam), jtrain.data,
        labels)
    want = _jax_rows(scorer(jtest.data).get())

    result = timit.run_on(train, test, cfg, num_classes)
    got = _port_scores(result["predictor"], test.data)
    _assert_same_scores(got, want)
    want_acc = float(np.mean(want.argmax(1) == _jax_rows(jtest.labels)))
    assert result["test_accuracy"] == pytest.approx(want_acc, abs=1e-12)
    assert result["train_seconds"] > 0.0


@pytest.mark.parametrize("num_iter", [1, 3])
@pytest.mark.parametrize("center", [True, False])
def test_bcd_epochs_match_jax(num_iter, center):
    """Correlated features in three blocks, so each epoch still moves."""
    rng = np.random.default_rng(11)
    n, d, k, block = 256, 96, 4, 32
    shared = rng.normal(size=(n, 8)).astype(np.float32)
    X = (shared @ rng.normal(size=(8, d)) + 0.3 * rng.normal(size=(n, d))
         ).astype(np.float32)
    Y = (X @ rng.normal(size=(d, k)) + 0.5 + rng.normal(size=(n, k))
         ).astype(np.float32)
    W, b = _bcd_fit(jnp.asarray(X), jnp.asarray(Y), jnp.ones(n),
                    jnp.float32(0.1), block, d // block, num_iter, center)
    epochs = []
    got_W, got_b, info = bcd_fit(torch.tensor(X), torch.tensor(Y), 0.1,
                                 block, num_iter, center,
                                 on_epoch=epochs.append)
    assert int(info) == 0 and epochs == list(range(num_iter))
    scale = SCORE_REL * float(np.abs(np.asarray(W)).max())
    np.testing.assert_allclose(got_W.numpy(), np.asarray(W), rtol=0,
                               atol=scale)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(b), rtol=0,
                               atol=scale)


def _labeled_rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 10, n).astype(np.int32),
            rng.normal(size=(n, d)).astype(np.float32))


def test_label_featured_csv_and_csv_loader_match_jax(tmp_path):
    y, X = _labeled_rows(37, 12)
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    got = LabeledData.label_featured_csv(str(path), device="cpu")
    want = JaxLabeledData.label_featured_csv(str(path))
    np.testing.assert_array_equal(got.labels.numpy(), _jax_rows(want.labels))
    np.testing.assert_array_equal(got.data.numpy(), _jax_rows(want.data))
    np.testing.assert_array_equal(got.labels.numpy(), y)
    np.testing.assert_array_equal(got.data.numpy(), X)
    plain = csv_data_loader(str(path), device="cpu")
    np.testing.assert_array_equal(plain.numpy(),
                                  _jax_rows(jax_csv_data_loader(str(path))))
    with pytest.raises(ValueError, match="align"):
        LabeledData.from_arrays(y[:3], X, device="cpu")


def test_timit_loader_matches_jax(tmp_path):
    _, X = _labeled_rows(20, 6, seed=1)
    feats, labs = tmp_path / "f.csv", tmp_path / "l.csv"
    np.savetxt(feats, X, delimiter=",", fmt="%.9g")
    # sparse labels: frames it does not name get label 0
    labs.write_text("0,3\n4,7\n\n19,2\n7,1\n")
    got = timit_loader(str(feats), str(labs), device="cpu")
    want = jax_timit_loader(str(feats), str(labs))
    np.testing.assert_array_equal(got.labels.numpy(), _jax_rows(want.labels))
    np.testing.assert_array_equal(got.data.numpy(), _jax_rows(want.data))
    assert got.labels.numpy()[[0, 4, 7, 19, 1]].tolist() == [3, 7, 1, 2, 0]


def test_mnist_cli_on_the_cpu():
    result = mnist.main(["--num-ffts", "2", "--block-size", "512",
                         "--lam", "1e-3", "--device", "cpu"])
    assert result["test_accuracy"] > 0.9


def test_timit_cli_on_the_cpu():
    result = timit.main(["--n-synth", "400", "--num-cosines", "256",
                         "--block-size", "128", "--num-epochs", "2",
                         "--device", "cpu"])
    assert 0.0 <= result["test_accuracy"] <= 1.0
    assert result["frames_per_sec"] > 0.0


@pytest.mark.parametrize("argv", [
    ["MnistRandomFFT", "--numFFTs", "2", "--blockSize", "512", "--device",
     "cpu"],
    ["pipelines.speech.TimitPipeline", "--n-synth", "400", "--num-cosines",
     "128", "--device", "cpu"],
    ["LinearPixels", "--synth-train", "40", "--synth-test", "20",
     "--device", "cpu"],
])
def test_launcher_runs_ported_pipelines_on_the_cpu(argv):
    assert launcher.main(argv) == 0


def test_launcher_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "TimitPipeline",
         "--n-synth", "200", "--num-cosines", "64", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "train_error=" in out.stdout


def test_launcher_from_the_pipelines_package():
    """``python -m keystone_tpu_torch.pipelines <Name>`` runs the launcher,
    as ``python -m keystone_tpu.pipelines`` does."""
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch.pipelines",
         "TimitPipeline", "--n-synth", "200", "--num-cosines", "64",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "train_error=" in out.stdout


@pytest.mark.parametrize("name", ["AmazonReviewsPipeline",
                                  "pipelines.text.NewsgroupsPipeline"])
def test_launcher_refuses_unported_pipelines(name, monkeypatch):
    """Every JAX pipeline is ported, so `NOT_PORTED` is empty; a name
    listed there, in either form, stops the launcher with a message."""
    assert launcher.NOT_PORTED == ()
    full = next(k for k in launcher.REGISTRY if k.endswith(name))
    monkeypatch.setattr(launcher, "REGISTRY", {
        k: v for k, v in launcher.REGISTRY.items() if k != full})
    monkeypatch.setattr(launcher, "NOT_PORTED", (full,))
    with pytest.raises(SystemExit, match="not ported yet"):
        launcher.main([name])


def test_launcher_refuses_multihost_flags_and_unknown_names(capsys):
    with pytest.raises(SystemExit, match="multi-host"):
        launcher.main(["--coordinator", "localhost:1234", "MnistRandomFFT"])
    assert launcher.main(["NoSuchPipeline"]) == 2
    assert launcher.main([]) == 0
    assert "pipelines.speech.TimitPipeline" in capsys.readouterr().out


def test_new_entry_points_raise_without_a_card(tmp_path):
    """Left at ``device="cuda"``, each new entry point raises with no
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path = tmp_path / "rows.csv"
    np.savetxt(path, np.ones((3, 4)), delimiter=",")
    calls = [
        lambda: mnist.run(mnist.MnistRandomFFTConfig(num_ffts=1)),
        lambda: mnist.main(["--num-ffts", "1"]),
        lambda: timit.run(timit.TimitConfig(n_synth=40, num_cosines=8)),
        lambda: timit.synthetic_timit(8, 4, 2, 0),
        lambda: timit_loader(str(path), str(path)),
        lambda: LabeledData.label_featured_csv(str(path)),
        lambda: LabeledData.from_arrays(np.zeros(3), np.ones((3, 4))),
        lambda: csv_data_loader(str(path)),
        lambda: RandomSignNode(4),
        lambda: CosineRandomFeatures(4, 8),
        lambda: launcher.main(["MnistRandomFFT", "--num-ffts", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
