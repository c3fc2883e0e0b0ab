"""VOCSIFTFisher and ImageNetSiftLcsFV, the class-weighted solver, the mAP
evaluator and the entry points: the port against the JAX package on the
CPU.

Both packages make the same synthetic images from numpy seeds
(`_synthetic_voc`, `_synthetic_imagenet`). The JAX side is fit stage by
stage with the JAX package's own nodes, as its `run` chains them (SIFT,
ColumnSampler, local PCA, the GMM Fisher vector, the per-image
normalizations, the stack, BWLS), so its fitted PCA, GMM and (W, b) can
be read and carried across with `convert.py`:

- carried across, the port's test scores lie within ``SCORE_RTOL`` of
  their largest magnitude of JAX's, with the same argmax and the same
  mAP or accuracy (measured: 1.4e-4 on VOC, 2.8e-5 on ImageNet, from
  the SIFT entries the two packages quantize 1 apart);
- fit end to end by the port, its PCA components lie within
  ``PCA_ATOL`` of JAX's (measured 8.0e-5 on VOC), its GMM means within
  ``GMM_RTOL`` of their largest (2.0e-4), its W within ``W_RTOL``
  (9.0e-4 on VOC, 8.8e-4 on ImageNet), and its test scores within
  ``SCORE_RTOL`` (8.6e-5), with the same argmax and the same mAP or
  accuracy as JAX's own `run`.

BWLS is held to `_bwls_fit` at ``BWLS_RTOL`` with masked and multi-label
rows: the port forms each class's Gram as a shared Gram plus one over the
class's rows, where JAX weights k full copies (measured 6.3e-7).
"""

import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keystone_tpu.data.dataset import (
    Dataset as JaxDataset,
    HostDataset as JaxHostDataset,
)
from keystone_tpu.evaluation import MeanAveragePrecisionEvaluator as JaxMAP
from keystone_tpu.nodes.images import (
    LCSExtractor as JaxLCS,
    MultiLabeledImageExtractor as JaxMultiImage,
    ScalaGMMFisherVectorEstimator as JaxFVEstimator,
    SIFTExtractor as JaxSIFT,
)
from keystone_tpu.nodes.images.core import (
    GrayScaler as JaxGray,
    PixelScaler as JaxPixel,
)
from keystone_tpu.nodes.learning import (
    BlockWeightedLeastSquaresEstimator as JaxBWLS,
)
from keystone_tpu.nodes.learning.pca import PCAEstimator as JaxPCA
from keystone_tpu.nodes.learning.weighted_ls import (
    PerClassWeightedLeastSquares as JaxPerClass,
    _bwls_fit,
)
from keystone_tpu.nodes.stats import (
    ColumnSampler as JaxColumnSampler,
    NormalizeRows as JaxNormalizeRows,
    SignedHellingerMapper as JaxHellinger,
)
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
    ClassLabelIndicatorsFromIntArray as JaxIndicatorsArray,
    MatrixVectorizer as JaxMatrixVectorizer,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.pipelines import imagenet_sift_lcs_fv as jax_imagenet
from keystone_tpu.pipelines import voc_sift_fisher as jax_voc
from keystone_tpu_torch import __main__ as launcher
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.nodes.learning.gmm import GaussianMixtureModel
from keystone_tpu_torch.nodes.learning.weighted_ls import (
    BlockWeightedLeastSquaresEstimator,
    PerClassWeightedLeastSquares,
    bwls_fit,
)
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
from keystone_tpu_torch.pipelines import voc_sift_fisher as voc
from keystone_tpu_torch.workflow.pipeline import Pipeline

REPO = pathlib.Path(__file__).resolve().parent.parent
SCORE_RTOL = 1e-3
PCA_ATOL = 5e-4
GMM_RTOL = 2e-3
W_RTOL = 1e-2
BWLS_RTOL = 1e-5
# tests/test_pipelines_e2e.py:115-129's configurations
VOC_CFG = dict(n_synth=30, num_classes=4, gmm_k=4, pca_dims=16)
IMAGENET_CFG = dict(n_synth=40, num_classes=5, gmm_k=4, pca_dims=16)


def _jax_rows(ds):
    return np.asarray(ds.array)[:ds.count]


def _jax_fit_branch(desc, dims, k, samples):
    """ColumnSampler → local PCA → ColumnSampler → GMM Fisher vector, as
    the JAX pipelines fit them."""
    pca = JaxPCA(dims).fit(JaxColumnSampler(samples).apply_batch(desc))
    fv = JaxFVEstimator(k).fit(JaxColumnSampler(samples).apply_batch(
        pca.apply_batch(desc)))
    return pca, fv


def _jax_encode(desc, pca, fv):
    x = fv.apply_batch(pca.apply_batch(desc))
    for node in (JaxMatrixVectorizer(), JaxHellinger(), JaxNormalizeRows()):
        x = x.map(node.apply)
    return x


def _branch_weights(pca, fv):
    g = fv.gmm
    return (np.asarray(pca.components), (np.asarray(g.means),
                                         np.asarray(g.variances),
                                         np.asarray(g.weights)))


@pytest.fixture(scope="module")
def jax_voc_fit():
    """JAX's VOCSIFTFisher fit at VOC_CFG, stage by stage, on a
    one-device mesh (its 8-device CPU mesh's all-reduces can abort the
    process; ROADMAP queue 3)."""
    with use_mesh(make_mesh(jax.devices()[:1])):
        return _jax_voc_fit()


def _jax_voc_fit():
    cfg = jax_voc.VOCSIFTFisherConfig(**VOC_CFG)
    train = jax_voc._synthetic_voc(cfg.n_synth, cfg.num_classes, cfg.seed)
    test = jax_voc._synthetic_voc(cfg.n_synth // 3, cfg.num_classes,
                                  cfg.seed + 1)

    def sift(ds):
        x = JaxGray().apply_batch(JaxPixel().apply_batch(
            JaxMultiImage().apply_batch(ds)))
        return JaxSIFT(step=6, num_scales=2).apply_batch(x)

    s_train = sift(train)
    pca, fv = _jax_fit_branch(s_train, cfg.pca_dims, cfg.gmm_k,
                              cfg.descriptor_samples)
    X = _jax_encode(s_train, pca, fv).stack(dtype=np.float32)
    Y = JaxIndicatorsArray(cfg.num_classes).apply_batch(
        JaxDataset(jax_voc._pad_labels(train, cfg.num_classes)))
    model = JaxBWLS(4096, 1, cfg.lam, cfg.mixture_weight).fit(X, Y)
    Xt = _jax_rows(_jax_encode(sift(test), pca, fv).stack(dtype=np.float32))
    scores = Xt @ np.asarray(model.W) + np.asarray(model.b)
    return dict(train=train, test=test, pca=pca, fv=fv, W=np.asarray(model.W),
                b=np.asarray(model.b), scores=scores,
                map=JaxMAP(cfg.num_classes)(scores, [
                    x.labels for x in test.items]).mean(),
                run_map=jax_voc.run(cfg)["map"])


def _assert_same_scores(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SCORE_RTOL * np.abs(want).max())


def test_voc_with_jax_weights_gives_jax_scores(jax_voc_fit):
    f = jax_voc_fit
    pca, mixture = _branch_weights(f["pca"], f["fv"])
    predictor = convert.fitted_voc_predictor(pca, *mixture, f["W"], f["b"],
                                             device="cpu")
    scores = predictor(HostDataset(f["test"].items, device="cpu")).get()
    got = scores.numpy()
    _assert_same_scores(got, f["scores"])
    labels = [x.labels for x in f["test"].items]
    assert MeanAveragePrecisionEvaluator(4)(scores, labels).mean() == f["map"]


def test_voc_end_to_end_fit_matches_jax(jax_voc_fit):
    f = jax_voc_fit
    out = voc.run(voc.VOCSIFTFisherConfig(**VOC_CFG), device="cpu")
    model = out["model"]
    np.testing.assert_allclose(
        model.pca.fitted().components.numpy(),
        np.asarray(f["pca"].components), rtol=0, atol=PCA_ATOL)
    means = np.asarray(f["fv"].gmm.means)
    np.testing.assert_allclose(model.fisher.fitted().gmm.means.numpy(), means,
                               rtol=0, atol=GMM_RTOL * np.abs(means).max())
    np.testing.assert_allclose(model.predictor.fitted().W.numpy(), f["W"], rtol=0,
                               atol=W_RTOL * np.abs(f["W"]).max())
    _assert_same_scores(out["scores"].numpy(), f["scores"])
    assert out["map"] == f["map"] == f["run_map"]
    assert len(out["aps"]) == 4 and out["seconds"] > 0


@pytest.fixture(scope="module")
def jax_imagenet_fit():
    """JAX's ImageNetSiftLcsFV fit at IMAGENET_CFG, stage by stage, on a
    one-device mesh, as `jax_voc_fit`."""
    with use_mesh(make_mesh(jax.devices()[:1])):
        return _jax_imagenet_fit()


def _jax_imagenet_fit():
    cfg = jax_imagenet.ImageNetSiftLcsFVConfig(**IMAGENET_CFG)
    train = jax_imagenet._synthetic_imagenet(cfg.n_synth, cfg.num_classes,
                                             cfg.seed)
    test = jax_imagenet._synthetic_imagenet(cfg.n_synth // 3,
                                            cfg.num_classes, cfg.seed + 1)

    def descriptors(ds):
        img = JaxPixel().apply_batch(JaxHostDataset([x.image for x in
                                                     ds.items]))
        return (JaxSIFT(step=6, num_scales=2).apply_batch(
            JaxGray().apply_batch(img)), JaxLCS(stride=6).apply_batch(img))

    d_train = descriptors(train)
    fits = [_jax_fit_branch(d, cfg.pca_dims, cfg.gmm_k,
                            cfg.descriptor_samples) for d in d_train]

    def features(descs):
        parts = [_jax_encode(d, *fit).items for d, fit in zip(descs, fits)]
        return np.stack([np.concatenate([np.ravel(np.asarray(v)) for v in
                                         xs]) for xs in zip(*parts)])

    labels = np.asarray([x.label for x in train.items], np.int32)
    Y = JaxIndicators(cfg.num_classes).apply_batch(JaxDataset(labels))
    model = JaxBWLS(4096, 1, cfg.lam).fit(
        JaxDataset(features(d_train).astype(np.float32)), Y)
    scores = (features(descriptors(test)) @ np.asarray(model.W)
              + np.asarray(model.b))
    actual = np.asarray([x.label for x in test.items])
    return dict(test=test, fits=fits, W=np.asarray(model.W),
                b=np.asarray(model.b), scores=scores,
                accuracy=float((scores.argmax(1) == actual).mean()),
                run_accuracy=jax_imagenet.run(cfg)["test_accuracy"])


def test_imagenet_with_jax_weights_gives_jax_classes(jax_imagenet_fit):
    f = jax_imagenet_fit
    (sift_pca, sift_gmm), (lcs_pca, lcs_gmm) = [
        _branch_weights(*fit) for fit in f["fits"]]
    predictor = convert.fitted_imagenet_predictor(
        sift_pca, sift_gmm, lcs_pca, lcs_gmm, f["W"], f["b"], device="cpu")
    test = HostDataset(f["test"].items, device="cpu")
    g = predictor.graph
    argmax = g.get_sink_dependency(predictor.sink)
    g = g.set_sink_dependency(predictor.sink, g.get_dependencies(argmax)[0])
    scores = Pipeline(g, predictor.source, predictor.sink)(test).get().numpy()
    _assert_same_scores(scores, f["scores"])
    got = predictor(test).get().numpy()
    np.testing.assert_array_equal(got, f["scores"].argmax(1))


def test_imagenet_end_to_end_matches_jax(jax_imagenet_fit):
    f = jax_imagenet_fit
    out = imagenet.run(imagenet.ImageNetSiftLcsFVConfig(**IMAGENET_CFG),
                       device="cpu")
    assert out["test_accuracy"] == f["accuracy"] == f["run_accuracy"]
    W = out["predictor"].fitted().W.numpy()
    np.testing.assert_allclose(W, f["W"], rtol=0,
                               atol=W_RTOL * np.abs(f["W"]).max())


def _weighted_problem(n=240, d=48, k=5, seed=0, masked=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = -np.ones((n, k), np.float32)
    for i in range(n):
        Y[i, rng.choice(k, size=rng.integers(1, 3), replace=False)] = 1.0
    mask = np.ones(n, np.float32)
    if masked:
        mask[-masked:] = 0.0
        Y[-masked:] = 0.0
    return X, Y, mask


@pytest.mark.parametrize("num_iter,masked,block", [(1, 9, 16), (2, 9, 16),
                                                   (1, 0, 48)],
                         ids=["one_pass_masked", "two_passes_masked",
                              "one_block"])
def test_bwls_matches_jax(num_iter, masked, block):
    X, Y, mask = _weighted_problem(masked=masked)
    d = X.shape[1]
    Wj, bj = _bwls_fit(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask),
                       jnp.float32(0.3), jnp.float32(0.7), block, d // block,
                       num_iter)
    W, b, info = bwls_fit(torch.from_numpy(X), torch.from_numpy(Y),
                          torch.from_numpy(mask), 0.3, 0.7, block, num_iter)
    assert int(info) == 0
    Wj, bj = np.asarray(Wj), np.asarray(bj)
    np.testing.assert_allclose(W.numpy(), Wj, rtol=0,
                               atol=BWLS_RTOL * np.abs(Wj).max())
    np.testing.assert_allclose(b.numpy(), bj, rtol=0,
                               atol=BWLS_RTOL * np.abs(bj).max())


def test_bwls_estimators_pad_and_match_jax():
    X, Y, _ = _weighted_problem(n=120, d=40, masked=0)
    want = JaxBWLS(16, 1, 0.5).fit(JaxDataset(X), JaxDataset(Y))
    got = BlockWeightedLeastSquaresEstimator(16, 1, 0.5).fit(
        Dataset(X, device="cpu"), Dataset(Y, device="cpu"))
    assert got.W.shape == (40, 5)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=0,
                               atol=BWLS_RTOL * np.abs(want.W).max())
    want = JaxPerClass(0.5).fit(JaxDataset(X), JaxDataset(Y))
    got = PerClassWeightedLeastSquares(0.5).fit(Dataset(X, device="cpu"),
                                                Dataset(Y, device="cpu"))
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), rtol=0,
                               atol=BWLS_RTOL * np.abs(want.W).max())
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=0,
                               atol=BWLS_RTOL * np.abs(want.b).max())


def test_map_evaluator_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    scores = np.round(rng.normal(size=(40, 5)), 1).astype(np.float32)
    actuals = [sorted(set(rng.integers(0, 4, size=rng.integers(1, 3))
                          .tolist())) for _ in range(40)]
    actuals[0] = []
    want = JaxMAP(5)(scores, actuals)
    got = MeanAveragePrecisionEvaluator(5)(
        Dataset(scores, device="cpu"), actuals)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        MeanAveragePrecisionEvaluator(5)(torch.from_numpy(scores), actuals),
        want)


def _sideband_files(tmp_path):
    """tests/test_pipelines_e2e.py::test_voc_sideband_model_files's
    files: PCA (k × d), GMM means and variances (dims × clusters)."""
    d, p, k = 128, 8, 4
    rng = np.random.default_rng(0)
    np.savetxt(tmp_path / "pca.csv", rng.normal(size=(p, d)).astype(
        np.float32), delimiter=",")
    np.savetxt(tmp_path / "m.csv", rng.normal(size=(p, k)), delimiter=",")
    np.savetxt(tmp_path / "v.csv", rng.uniform(0.5, 1.5, size=(p, k)),
               delimiter=",")
    np.savetxt(tmp_path / "w.csv", np.full(k, 1.0 / k), delimiter=",")
    return dict(num_classes=3, n_synth=9, gmm_k=k, pca_dims=p,
                pca_file=str(tmp_path / "pca.csv"),
                gmm_mean_file=str(tmp_path / "m.csv"),
                gmm_var_file=str(tmp_path / "v.csv"),
                gmm_wts_file=str(tmp_path / "w.csv"))


def test_voc_sideband_model_files(tmp_path):
    cfg = _sideband_files(tmp_path)
    got = voc.run(voc.VOCSIFTFisherConfig(**cfg), device="cpu")
    want = jax_voc.run(jax_voc.VOCSIFTFisherConfig(**cfg))
    assert np.isfinite(got["map"]) and len(got["aps"]) == 3
    np.testing.assert_allclose(got["aps"], want["aps"], rtol=0, atol=1e-12)
    gmm = got["model"].fisher.gmm
    assert gmm.means.shape == (4, 8) and gmm.weights.shape == (4,)
    with pytest.raises(ValueError, match="gmm-var-file"):
        voc.run(voc.VOCSIFTFisherConfig(**dict(cfg, gmm_var_file=None)),
                device="cpu")


def test_voc_cli_on_the_cpu(capsys):
    voc.main(["--n-synth", "12", "--num-classes", "3", "--gmm-k", "2",
              "--pca-dims", "8", "--device", "cpu"])
    assert "mAP=" in capsys.readouterr().out


def test_imagenet_cli_on_the_cpu(capsys):
    imagenet.main(["--n-synth", "15", "--num-classes", "3", "--device",
                   "cpu"])
    assert "accuracy=" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["VOCSIFTFisher", "--nSynth", "12", "--numClasses", "3", "--gmm-k", "2",
     "--device", "cpu"],
    ["pipelines.images.imagenet.ImageNetSiftLcsFV", "--n-synth", "15",
     "--num-classes", "3", "--device", "cpu"],
], ids=["voc", "imagenet"])
def test_launcher_runs_the_sift_fisher_pipelines_on_the_cpu(argv):
    assert launcher.main(argv) == 0


def test_launcher_runs_voc_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "VOCSIFTFisher",
         "--n-synth", "12", "--num-classes", "3", "--gmm-k", "2",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "mAP=" in out.stdout


@pytest.mark.parametrize("call", [
    lambda: voc.run(voc.VOCSIFTFisherConfig(train_tar="voc.tar"),
                    device="cpu"),
    lambda: voc.main(["--train-tar", "voc.tar", "--device", "cpu"]),
    lambda: imagenet.run(imagenet.ImageNetSiftLcsFVConfig(
        train_tar="imagenet.tar"), device="cpu"),
    lambda: imagenet.main(["--train-tar", "imagenet.tar", "--device",
                           "cpu"]),
], ids=["voc_run", "voc_main", "imagenet_run", "imagenet_main"])
def test_train_tar_raises_until_the_loaders_are_ported(call):
    with pytest.raises(NotImplementedError, match="image loaders"):
        call()


def test_sift_fisher_entry_points_raise_without_a_card(tmp_path):
    """Left at ``device="cuda"``, each new entry point raises with no
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = _sideband_files(tmp_path)
    train = voc._synthetic_voc(6, 3, 0)
    calls = [
        lambda: voc.run(voc.VOCSIFTFisherConfig(n_synth=6, num_classes=3)),
        lambda: voc.main(["--n-synth", "6"]),
        lambda: voc.run_on(train, train, voc.VOCSIFTFisherConfig()),
        lambda: voc.build(train, voc.VOCSIFTFisherConfig()),
        lambda: imagenet.run(imagenet.ImageNetSiftLcsFVConfig(n_synth=6)),
        lambda: imagenet.main(["--n-synth", "6"]),
        lambda: launcher.main(["VOCSIFTFisher", "--n-synth", "6"]),
        lambda: launcher.main(["ImageNetSiftLcsFV", "--n-synth", "6"]),
        lambda: GaussianMixtureModel.load_csv(
            cfg["gmm_mean_file"], cfg["gmm_var_file"], cfg["gmm_wts_file"]),
        lambda: HostDataset([np.zeros(3, np.float32)]).stack(),
        lambda: convert.gmm(np.ones((2, 3)), np.ones((2, 3)), np.ones(2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
