"""The augmentation nodes, the augmented evaluator and the three CIFAR
pipelines that use them (RandomCifar, RandomPatchCifarAugmented,
RandomPatchCifarAugmentedKernel): the port against the JAX package on
the CPU.

Both packages draw every crop, flip and shuffle from numpy with the same
seeds, so the augmented arrays must be bit for bit the same, and the
evaluator's confusion matrices equal. The pipelines' learned filters and
whitener are JAX's, carried across with `keystone_tpu_torch.convert`
(RandomCifar's numpy filters are the same by construction); the port
then fits its own scaler and solver, and its test scores must lie within
1e-4 of their largest magnitude of JAX's, with the same argmax.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.evaluation import (
    AugmentedExamplesEvaluator as JaxAugmentedEvaluator,
)
from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.nodes.images.core import (
    CenterCornerPatcher as JaxCenterCornerPatcher,
    Convolver as JaxConvolver,
    Cropper as JaxCropper,
    ImageVectorizer as JaxImageVectorizer,
    PixelScaler as JaxPixelScaler,
    Pooler as JaxPooler,
    RandomImageTransformer as JaxRandomImageTransformer,
    RandomPatcher as JaxRandomPatcher,
    SymmetricRectifier as JaxSymmetricRectifier,
    Windower as JaxWindower,
)
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBlockLeastSquares,
    KernelRidgeRegression as JaxKernelRidgeRegression,
)
from keystone_tpu.nodes.stats import StandardScaler as JaxStandardScaler
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
)
from keystone_tpu.nodes.util.fusion import (
    FusedBatchTransformer as JaxFusedBatchTransformer,
)
from keystone_tpu.pipelines.random_patch_cifar import (
    learn_filters as jax_learn_filters,
)
from keystone_tpu.utils import images as jax_images
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.evaluation import AugmentedExamplesEvaluator
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.nodes.images import (
    CenterCornerPatcher,
    Cropper,
    RandomImageTransformer,
    RandomPatcher,
    Windower,
)
from keystone_tpu_torch.nodes.learning import (
    BlockLeastSquaresEstimator,
    KernelRidgeRegression,
)
from keystone_tpu_torch.nodes.learning import kernels as port_kernels
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromInt
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.pipelines import cifar_variants as cv
from keystone_tpu_torch.utils import images as port_images
from keystone_tpu_torch.workflow.pipeline import Pipeline

# 45 training images: not a multiple of the JAX mesh's 8 shards, so its
# padded rows are in play; 180 crops in 64-row KRR blocks, the last ragged
N_TRAIN, N_TEST = 45, 15
AUG_CFG = dict(num_filters=16, microbatch=32, sample_patches=5000,
               block_size=4096, lam=10.0)
AUG_KERNEL_CFG = dict(AUG_CFG, kernel_block=64, gamma=2e-4,
                      kernel_epochs=1)
RANDOM_CFG = dict(num_filters=16, microbatch=32, block_size=64)
N_RANDOM_TRAIN, N_RANDOM_TEST = 300, 100


def _same(port_ds, jax_ds):
    assert port_ds.count == jax_ds.count
    np.testing.assert_array_equal(port_ds.numpy(), np.asarray(jax_ds.numpy()))


def _assert_same_predictions(got_scores, want_scores, rel=1e-4):
    assert got_scores.shape == want_scores.shape
    np.testing.assert_array_equal(got_scores.argmax(1),
                                  want_scores.argmax(1))
    np.testing.assert_allclose(
        got_scores, want_scores, rtol=0,
        atol=rel * float(np.abs(want_scores).max()))


@pytest.fixture(scope="module")
def data():
    jtrain, jtest = jax_synthetic(N_TRAIN, N_TEST, noise=1.2, confusion=0.6)
    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device="cpu")
    return jtrain, jtest, train, test


# ---- the augmentation nodes, bit for bit ---------------------------------


def test_crop_and_flip_match_jax(data):
    """One image and a batch: `crop` and `flip_horizontal` index the last
    three axes as the JAX package's do."""
    _, _, train, _ = data
    imgs = train.data.numpy()
    for x in (imgs[3], imgs[:5]):
        t = torch.as_tensor(x)
        want_flip = (jax_images.flip_horizontal(x) if x.ndim == 3
                     else x[:, :, ::-1, :])
        np.testing.assert_array_equal(
            port_images.flip_horizontal(t).numpy(), np.asarray(want_flip))
        want_crop = (jax_images.crop(x, 2, 5, 20, 29) if x.ndim == 3
                     else x[:, 2:20, 5:29, :])
        np.testing.assert_array_equal(
            port_images.crop(t, 2, 5, 20, 29).numpy(), np.asarray(want_crop))


def test_cropper_matches_jax(data):
    jtrain, _, train, _ = data
    _same(Cropper(3, 1, 27, 30).apply_batch(train.data),
          JaxCropper(3, 1, 27, 30).apply_batch(jtrain.data))


@pytest.mark.parametrize("stride,window", [(1, 6), (5, 8), (13, 14)])
def test_windower_matches_jax(data, stride, window):
    """Every window, image-major, and the count times gy·gx."""
    jtrain, _, train, _ = data
    _same(Windower(stride, window).apply_batch(train.data),
          JaxWindower(stride, window).apply_batch(jtrain.data))
    one = train.data.numpy()[7]
    np.testing.assert_array_equal(
        Windower(stride, window).apply(one).numpy(),
        JaxWindower(stride, window).apply(one))


@pytest.mark.parametrize("ppi,patch,seed", [(4, 24, 0), (3, 17, 5)])
def test_random_patcher_matches_jax(data, ppi, patch, seed):
    """The same numpy offsets ys then xs, gathered on the device: the same
    crops in the same (image, crop) order."""
    jtrain, _, train, _ = data
    got = RandomPatcher(ppi, patch, patch, seed=seed).apply_batch(train.data)
    want = JaxRandomPatcher(ppi, patch, patch, seed=seed).apply_batch(
        jtrain.data)
    assert got.count == N_TRAIN * ppi
    _same(got, want)


def test_random_patcher_single_datum_matches_jax(data):
    """One datum draws from a generator kept across calls, in both."""
    _, _, train, _ = data
    img = train.data.numpy()[0]
    port, jax_ = RandomPatcher(1, 20, 20, seed=3), JaxRandomPatcher(
        1, 20, 20, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(
            port.apply(torch.as_tensor(img)).numpy(), jax_.apply(img))


@pytest.mark.parametrize("with_flips", [False, True])
def test_center_corner_patcher_matches_jax(data, with_flips):
    """Four corners then the centre (then their flips), image-major."""
    _, jtest, _, test = data
    got = CenterCornerPatcher(24, 24, with_flips).apply_batch(test.data)
    want = JaxCenterCornerPatcher(24, 24, with_flips).apply_batch(jtest.data)
    assert got.count == N_TEST * (10 if with_flips else 5)
    _same(got, want)
    one = test.data.numpy()[2]
    np.testing.assert_array_equal(
        CenterCornerPatcher(24, 24, with_flips).apply(one).numpy(),
        JaxCenterCornerPatcher(24, 24, with_flips).apply(one))


@pytest.mark.parametrize("prob,seed", [(0.5, 1), (0.2, 9)])
def test_random_image_transformer_flips_match_jax(data, prob, seed):
    """The flip mask default_rng(seed).random(count) < p, applied with a
    device `torch.where`: the same images flipped."""
    jtrain, _, train, _ = data
    got = RandomImageTransformer(prob, port_images.flip_horizontal,
                                 seed=seed).apply_batch(train.data)
    want = JaxRandomImageTransformer(prob, jax_images.flip_horizontal,
                                     seed=seed).apply_batch(jtrain.data)
    _same(got, want)
    flipped = np.any(got.numpy() != train.data.numpy(), axis=(1, 2, 3))
    assert 0 < flipped.sum() < N_TRAIN


def test_random_image_transformer_host_path_matches_jax(data):
    """A transform not marked batchable runs image by image on the host
    in both packages."""
    jtrain, _, train, _ = data

    def halve(img):
        return img * 0.5

    got = RandomImageTransformer(0.5, halve, seed=4).apply_batch(train.data)
    want = JaxRandomImageTransformer(0.5, halve, seed=4).apply_batch(
        jtrain.data)
    _same(got, want)


# ---- the augmented evaluator ----------------------------------------------


@pytest.fixture(scope="module")
def augmented_rows():
    """60 examples, 1 to 6 views each, in shuffled order; scores with
    some exact ties (rounded to 0.5) so Borda's stable ranks matter."""
    rng = np.random.default_rng(11)
    views = rng.integers(1, 7, size=60)
    ids = np.repeat(np.arange(60) * 7 + 3, views)
    labels = np.repeat(rng.integers(0, 10, size=60), views)
    scores = np.round(rng.normal(size=(ids.size, 10)) * 2) / 2
    order = rng.permutation(ids.size)
    return ids[order], scores[order].astype(np.float32), labels[order]


@pytest.mark.parametrize("agg", ["mean", "max", "borda"])
def test_augmented_evaluator_matches_jax(augmented_rows, agg):
    """The device group reduction gives the JAX package's confusion
    matrix, whether ids come as an array or a tensor."""
    ids, scores, labels = augmented_rows
    want = JaxAugmentedEvaluator(10, agg)(ids, scores, labels).confusion
    for id_arg in (ids, torch.as_tensor(ids)):
        got = AugmentedExamplesEvaluator(10, agg)(
            id_arg, torch.as_tensor(scores), torch.as_tensor(labels))
        np.testing.assert_array_equal(got.confusion, want)
    assert got.total == 60


def test_augmented_evaluator_refuses_inconsistent_labels(augmented_rows):
    """One view of a group of several gets another label: both packages
    refuse it."""
    ids, scores, labels = augmented_rows
    keys, counts = np.unique(ids, return_counts=True)
    row = np.nonzero(ids == keys[np.argmax(counts > 1)])[0][-1]
    labels = labels.copy()
    labels[row] = (labels[row] + 1) % 10
    with pytest.raises(ValueError, match="inconsistent labels"):
        JaxAugmentedEvaluator(10)(ids, scores, labels)
    with pytest.raises(ValueError, match="inconsistent labels"):
        AugmentedExamplesEvaluator(10)(ids, scores, labels)
    with pytest.raises(ValueError, match="agg must be"):
        AugmentedExamplesEvaluator(10, "median")


# ---- RandomCifar ----------------------------------------------------------


@pytest.fixture(scope="module")
def random_cifar():
    jtrain, jtest = jax_synthetic(N_RANDOM_TRAIN, N_RANDOM_TEST, noise=1.2,
                                  confusion=0.6)
    train, test = synthetic_cifar(N_RANDOM_TRAIN, N_RANDOM_TEST, noise=1.2,
                                  confusion=0.6, device="cpu")
    config = cv.RandomCifarConfig(**RANDOM_CFG)
    # the JAX package's draw (`cifar_variants.py:124-127`), inline there
    rng = np.random.default_rng(config.seed)
    filters = rng.normal(size=(16, 6 * 6 * 3)).astype(np.float32)
    filters /= np.linalg.norm(filters, axis=1, keepdims=True)
    featurizer = JaxFusedBatchTransformer(
        [JaxPixelScaler(),
         JaxConvolver(filters, 32, 32, 3, whitener=None,
                      normalize_patches=True),
         JaxSymmetricRectifier(alpha=config.alpha),
         JaxPooler(config.pool_stride, config.pool_size, pool_fn="sum"),
         JaxImageVectorizer()], microbatch=config.microbatch)
    feats = featurizer.apply_batch(jtrain.data)
    scaler = JaxStandardScaler().fit(feats)
    model = JaxBlockLeastSquares(config.block_size, 1, config.lam).fit(
        scaler.apply_batch(feats), JaxIndicators(10).apply_batch(
            jtrain.labels))
    scores = model.apply_batch(scaler.apply_batch(
        featurizer.apply_batch(jtest.data))).numpy()
    return dict(filters=filters, train=train, test=test, config=config,
                scores=np.asarray(scores))


def test_random_cifar_filters_are_jax_draw(random_cifar):
    np.testing.assert_array_equal(cv.random_filters(random_cifar["config"]),
                                  random_cifar["filters"])


def test_random_cifar_port_fit_matches_jax(random_cifar):
    """`build_random_cifar`'s own fit (its filters are JAX's by
    construction) scores the test set as JAX's pipeline does."""
    r = random_cifar
    predictor = cv.build_random_cifar(r["train"], r["config"])
    # the predictor's graph with its sink moved off the final
    # MaxClassifier: the scores
    g = predictor.graph
    argmax = g.get_sink_dependency(predictor.sink)
    g = g.set_sink_dependency(predictor.sink, g.get_dependencies(argmax)[0])
    scorer = Pipeline(g, predictor.source, predictor.sink)
    got = scorer(r["test"].data).get().numpy()
    _assert_same_predictions(got, r["scores"])


# ---- RandomPatchCifarAugmented -------------------------------------------


def _jax_augmented_featurizer(filters, whitener, config):
    ap = config.aug_patch
    return JaxFusedBatchTransformer(
        [JaxPixelScaler(),
         JaxConvolver(filters, ap, ap, 3, whitener=whitener),
         JaxSymmetricRectifier(alpha=config.alpha),
         JaxPooler(max(ap // 2 - 1, 1), ap // 2, pool_fn="sum"),
         JaxImageVectorizer()], microbatch=config.microbatch)


def _jax_views(jtest, with_flips):
    views = JaxCenterCornerPatcher(24, 24, with_flips).apply_batch(jtest.data)
    k = 10 if with_flips else 5
    ids = np.repeat(np.arange(N_TEST), k)
    labels = np.repeat(np.asarray(jtest.labels.numpy()), k)
    return views, ids, labels


@pytest.fixture(scope="module")
def augmented(data):
    """RandomPatchCifarAugmented as `cifar_variants.py:216-266` runs it,
    its parts kept."""
    jtrain, jtest, _, _ = data
    config = cv.RandomPatchCifarAugmentedConfig(**AUG_CFG)
    crops = JaxRandomPatcher(4, 24, 24, seed=config.seed).apply_batch(
        jtrain.data)
    labels = np.repeat(np.asarray(jtrain.labels.numpy()), 4)
    filters, whitener = jax_learn_filters(crops, config)
    featurizer = _jax_augmented_featurizer(filters, whitener, config)
    feats = featurizer.apply_batch(crops)
    scaler = JaxStandardScaler().fit(feats)
    model = JaxBlockLeastSquares(config.block_size, 1, config.lam).fit(
        scaler.apply_batch(feats),
        JaxIndicators(10).apply_batch(JaxDataset(labels.astype(np.int32))))
    views, ids, actuals = _jax_views(jtest, with_flips=False)
    scores = np.asarray(model.apply_batch(scaler.apply_batch(
        featurizer.apply_batch(views))).numpy())
    metrics = JaxAugmentedEvaluator(10)(ids, scores, actuals)
    return dict(crops=crops, labels=labels, filters=np.asarray(filters),
                whitener=whitener, scaler=scaler, model=model, scores=scores,
                confusion=metrics.confusion, config=config)


def _port_featurizer(k):
    return cv.augmented_featurizer(
        convert.to_tensor(k["filters"], "cpu"),
        convert.whitener(k["whitener"].whitener, k["whitener"].means, "cpu"),
        k["config"])


def test_augmented_training_crops_match_jax(augmented, data):
    aug = cv.random_crops(data[2], augmented["config"])
    _same(aug.data, augmented["crops"])
    np.testing.assert_array_equal(aug.labels.numpy(), augmented["labels"])


def test_augmented_features_are_one_window(augmented, data):
    """24×24 crops, P 6, pool 12 stride 11: one window an axis, so 2K
    features; the kernel's row plan keeps the 144 covered positions of
    the 19×19 conv output and skips the other 217."""
    _, _, train, _ = data
    aug = cv.random_crops(train, augmented["config"])
    feats = _port_featurizer(augmented).apply_batch(aug.data)
    assert tuple(feats.array.shape) == (4 * N_TRAIN, 32)
    rows, groups = kernels.conv_row_plan(19, 19, 12, 11)
    covered = rows[rows >= 0]
    assert covered.numel() == 144 and rows.numel() == 144
    assert sorted((covered // 19).unique().tolist()) == list(range(12))
    assert groups.unique().tolist() == [0]


def test_augmented_port_fit_matches_jax(augmented, data):
    """With JAX's filters and whitener, the port featurizes the same
    crops, fits its scaler and BCD, and scores the five test views as
    JAX does; the averaged views give JAX's confusion matrix."""
    a = augmented
    _, _, train, test = data
    aug = cv.random_crops(train, a["config"])
    featurizer = _port_featurizer(a)
    feats = featurizer.apply_batch(aug.data)
    scaler = StandardScaler().fit(feats)
    model = BlockLeastSquaresEstimator(a["config"].block_size, 1,
                                       a["config"].lam).fit(
        scaler.apply_batch(feats),
        ClassLabelIndicatorsFromInt(10).apply_batch(aug.labels))
    views, ids, labels = cv.center_corner_views(test, a["config"], False)
    got = model.apply_batch(scaler.apply_batch(
        featurizer.apply_batch(views))).numpy()
    _assert_same_predictions(got, a["scores"])
    metrics = AugmentedExamplesEvaluator(10)(ids, torch.as_tensor(got),
                                             labels)
    np.testing.assert_array_equal(metrics.confusion, a["confusion"])


def test_augmented_carried_fit_matches_jax(augmented, data):
    """JAX's filters, whitener, scaler and BCD weights in the port's
    scorer."""
    a = augmented
    w = a["whitener"]
    scorer = convert.fitted_augmented_scorer(
        a["filters"], w.whitener, w.means, a["scaler"].mean, a["scaler"].std,
        convert.block_linear_mapper(a["model"].W, a["model"].b, "cpu"),
        a["config"], device="cpu")
    views, _, _ = cv.center_corner_views(data[3], a["config"], False)
    _assert_same_predictions(scorer(views).get().numpy(), a["scores"])


def test_build_random_patch_cifar_augmented_learns(data):
    """The port's own pipeline, filters from its own generator: it fits
    the 180 crops and scores the test views above chance."""
    _, _, train, test = data
    config = cv.RandomPatchCifarAugmentedConfig(**AUG_CFG)
    aug = cv.random_crops(train, config)
    scorer = cv.build_random_patch_cifar_augmented(aug, config)
    metrics = cv.score_center_corner_views(scorer, test, config, False)
    assert metrics.total == N_TEST
    assert metrics.accuracy > 0.2


# ---- RandomPatchCifarAugmentedKernel -------------------------------------


@pytest.fixture(scope="module")
def augmented_kernel(data):
    """RandomPatchCifarAugmentedKernel as `cifar_variants.py:281-354`
    runs it, its parts kept."""
    jtrain, jtest, _, _ = data
    config = cv.RandomPatchCifarAugmentedKernelConfig(**AUG_KERNEL_CFG)
    crops = JaxRandomImageTransformer(
        config.flip_chance, jax_images.flip_horizontal, seed=config.seed + 1
    ).apply_batch(JaxRandomPatcher(4, 24, 24, seed=config.seed).apply_batch(
        jtrain.data))
    labels = np.repeat(np.asarray(jtrain.labels.numpy()), 4)
    perm = np.random.default_rng(config.seed + 2).permutation(len(labels))
    crops = JaxDataset(np.asarray(crops.numpy())[perm])
    labels = labels[perm]
    filters, whitener = jax_learn_filters(crops, config)
    featurizer = _jax_augmented_featurizer(filters, whitener, config)
    feats = featurizer.apply_batch(crops)
    scaler = JaxStandardScaler().fit(feats)
    model = JaxKernelRidgeRegression(
        config.gamma, config.lam, config.kernel_block, config.kernel_epochs,
        seed=config.seed).fit(
        scaler.apply_batch(feats),
        JaxIndicators(10).apply_batch(JaxDataset(labels.astype(np.int32))))
    views, ids, actuals = _jax_views(jtest, with_flips=True)
    scores = np.asarray(model.apply_batch(scaler.apply_batch(
        featurizer.apply_batch(views))).numpy())
    metrics = JaxAugmentedEvaluator(10)(ids, scores, actuals)
    return dict(crops=crops, labels=labels, filters=np.asarray(filters),
                whitener=whitener, scaler=scaler, model=model, scores=scores,
                confusion=metrics.confusion, config=config)


def test_augmented_kernel_training_views_match_jax(augmented_kernel, data):
    """Crops, flips (seed + 1) and one shuffle (seed + 2) of images and
    labels: the same arrays as JAX's."""
    aug = cv.flipped_shuffled_crops(data[2], augmented_kernel["config"])
    _same(aug.data, augmented_kernel["crops"])
    np.testing.assert_array_equal(aug.labels.numpy(),
                                  augmented_kernel["labels"])


def _port_augmented_kernel_scores(k, train, test, **krr):
    config = k["config"]
    aug = cv.flipped_shuffled_crops(train, config)
    featurizer = _port_featurizer(k)
    feats = featurizer.apply_batch(aug.data)
    scaler = StandardScaler().fit(feats)
    model = KernelRidgeRegression(
        config.gamma, config.lam, config.kernel_block, config.kernel_epochs,
        seed=config.seed, **krr).fit(
        scaler.apply_batch(feats),
        ClassLabelIndicatorsFromInt(10).apply_batch(aug.labels))
    views, ids, labels = cv.center_corner_views(test, config, True)
    got = model.apply_batch(scaler.apply_batch(
        featurizer.apply_batch(views))).numpy()
    return got, AugmentedExamplesEvaluator(10)(ids, torch.as_tensor(got),
                                               labels)


def test_augmented_kernel_port_fit_matches_jax(augmented_kernel, data):
    """With JAX's filters and whitener, the port's KRR (three 64-row
    blocks of the 180 shuffled crops, seeded as JAX's) scores the ten
    test views as JAX does, and gives JAX's confusion matrix."""
    got, metrics = _port_augmented_kernel_scores(augmented_kernel, data[2],
                                                 data[3])
    _assert_same_predictions(got, augmented_kernel["scores"])
    np.testing.assert_array_equal(metrics.confusion,
                                  augmented_kernel["confusion"])


def test_augmented_kernel_checkpoint_round_trip_matches_jax(
        augmented_kernel, data, tmp_path, monkeypatch):
    """A fit cut after its second block leaves a checkpoint; the next fit
    on the same data resumes from it, ends with JAX's scores, and deletes
    it."""
    real_step, steps = port_kernels.krr_step, []

    def cut_after_two(*args):
        if len(steps) == 2:
            raise RuntimeError("cut")
        steps.append(1)
        return real_step(*args)

    monkeypatch.setattr(port_kernels, "krr_step", cut_after_two)
    with pytest.raises(RuntimeError, match="cut"):
        _port_augmented_kernel_scores(
            augmented_kernel, data[2], data[3],
            checkpoint_dir=str(tmp_path), blocks_before_checkpoint=1)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    resumed = []
    monkeypatch.setattr(port_kernels, "krr_step",
                        lambda *a: resumed.append(1) or real_step(*a))
    got, _ = _port_augmented_kernel_scores(
        augmented_kernel, data[2], data[3], checkpoint_dir=str(tmp_path),
        blocks_before_checkpoint=1)
    assert len(resumed) == 1  # the third block only
    assert not list(tmp_path.glob("*.npz"))
    _assert_same_predictions(got, augmented_kernel["scores"])


def test_augmented_kernel_carried_fit_matches_jax(augmented_kernel, data):
    """JAX's filters, whitener, scaler and kernel model (anchors and
    alpha, padded rows dropped) in the port's scorer."""
    k = augmented_kernel
    w, model = k["whitener"], k["model"]
    n = 4 * N_TRAIN
    scorer = convert.fitted_augmented_scorer(
        k["filters"], w.whitener, w.means, k["scaler"].mean, k["scaler"].std,
        convert.kernel_mapper(np.asarray(model.train_X)[:n],
                              np.asarray(model.alpha)[:n], model.gamma,
                              model.block_size, "cpu"),
        k["config"], device="cpu")
    views, _, _ = cv.center_corner_views(data[3], k["config"], True)
    _assert_same_predictions(scorer(views).get().numpy(), k["scores"])


# ---- the CLI and the card -------------------------------------------------


@pytest.mark.parametrize("pipeline,extra", [
    ("random-cifar", ["--num-filters", "8"]),
    ("augmented", ["--num-filters", "8", "--patches-per-image", "2"]),
    ("augmented-kernel", ["--num-filters", "8", "--kernel-block", "32"]),
])
def test_new_cli_choices_run_on_the_cpu(pipeline, extra, capsys, tmp_path):
    if pipeline == "augmented-kernel":
        extra = extra + ["--checkpoint-dir", str(tmp_path)]
    result = cv.main([pipeline, "--synth-train", "40", "--synth-test", "16",
                      "--device", "cpu"] + extra)
    assert 0.0 <= result["test_accuracy"] <= 1.0
    assert "train_error=" in capsys.readouterr().out


def test_cli_refuses_options_of_other_pipelines():
    with pytest.raises(SystemExit):
        cv.main(["random-cifar", "--gamma", "0.1", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cv.main(["augmented", "--checkpoint-dir", "x", "--device", "cpu"])


def test_cpu_augmented_run_launches_no_kernel(data):
    """On the CPU every wrapper takes its plain version."""
    kernels.reset_launches()
    _, _, train, test = data
    cv.run_random_patch_cifar_augmented_kernel(
        cv.RandomPatchCifarAugmentedKernelConfig(
            num_filters=8, kernel_block=64, synth_train=20, synth_test=8),
        device="cpu")
    assert kernels.conv_rectify_pool.launches == 0
    assert kernels.rbf_block.launches == 0
    assert kernels.rbf_split.launches == 0


def test_new_entry_points_raise_without_a_card():
    """Left at device="cuda", each new entry point asks for the card and
    raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    small = dict(synth_train=8, synth_test=4)
    for run, config in (
            (cv.run_random_cifar, cv.RandomCifarConfig(**small)),
            (cv.run_random_patch_cifar_augmented,
             cv.RandomPatchCifarAugmentedConfig(**small)),
            (cv.run_random_patch_cifar_augmented_kernel,
             cv.RandomPatchCifarAugmentedKernelConfig(**small))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(config)
    for choice in ("random-cifar", "augmented", "augmented-kernel"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cv.main([choice, "--synth-train", "8", "--synth-test", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Dataset(np.zeros((4, 24, 24, 3), np.float32))
