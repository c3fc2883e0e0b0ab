"""CIFAR variants on one CUDA card: LinearPixels, RandomCifar,
RandomPatchCifarKernel, RandomPatchCifarAugmented and
RandomPatchCifarAugmentedKernel.

Counterpart of `keystone_tpu/pipelines/cifar_variants.py`:

- LinearPixels (`:57-113`; reference LinearPixels.scala):
  PixelScaler → GrayScaler → ImageVectorizer as one
  `FusedBatchTransformer` over 4096-row microbatches, whose three stages
  run as one elementwise chain kernel launch, then a `Cacher`,
  `LinearMapEstimator(λ)` and `MaxClassifier`.
- RandomCifar (`:116-161`; RandomCifar.scala): unit-norm Gaussian
  filters drawn with numpy from the seed (so both packages hold the same
  bank), no whitener, the RandomPatchCifar featurizer on the fused
  conv+rectify+pool kernel, `StandardScaler` and one BCD sweep.
- RandomPatchCifarKernel (`:163-207`; RandomPatchCifarKernel.scala:62-75):
  RandomPatchCifar's learned filters and featurizer, then
  `StandardScaler` and `KernelRidgeRegression`, whose block steps and
  apply run the RBF block kernel.
- RandomPatchCifarAugmented (`:210-266`; RandomPatchCifarAugmented.scala):
  four random 24×24 crops an image (`RandomPatcher`), filters learned on
  the crops, the featurizer at 24×24 with one 12×12 pool window
  (`Pooler(max(ap//2 − 1, 1), ap//2)`: stride 11, pool 12), one BCD
  sweep; at test the four corner and the centre crops
  (`CenterCornerPatcher`), their scores averaged an image by
  `AugmentedExamplesEvaluator`.
- RandomPatchCifarAugmentedKernel (`:268-354`;
  RandomPatchCifarAugmentedKernel.scala): the crops, then horizontal
  flips with probability 0.5 (seed + 1), then one numpy permutation
  (seed + 2) of images and labels, applied on the device;
  `KernelRidgeRegression` at γ 2e-4 with its seed and checkpointing; ten
  test views (the five crops and their flips).

The ``build_*`` functions fit on given training data (the augmented
ones on given training views, from `random_crops` or
`flipped_shuffled_crops`); the ``run_*`` functions load or synthesize
the data, fit and score.

On a mesh (JAX fits the same graphs on row-sharded data; `parallel/`)
RandomPatchCifarKernel takes each rank's rows as RandomPatchCifar does:
filters learned once and broadcast, K1 and K5 on each rank's rows, the
KRR's blocks gathered (`nodes/learning/kernels.py`). The augmented pair
draws its crops, flips and shuffle once over the whole training set in
global order, as one process does, and places the views on the ranks
(`_placed`), so every rank's views are one process's rows bit for bit;
K1 runs at 24×24 on each rank's crops, and the test views' scores are
gathered by `AugmentedExamplesEvaluator`. Each ``run_*`` takes the
current mesh (none in one process).

    python -m keystone_tpu_torch.pipelines.cifar_variants linear-pixels
    python -m keystone_tpu_torch.pipelines.cifar_variants kernel --device cpu
    python -m keystone_tpu_torch.pipelines.cifar_variants random-cifar
    python -m keystone_tpu_torch.pipelines.cifar_variants augmented
    python -m keystone_tpu_torch.pipelines.cifar_variants augmented-kernel \
        --checkpoint-dir ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.dataset import Dataset
from ..evaluation import (
    AugmentedExamplesEvaluator,
    MulticlassClassifierEvaluator,
)
from ..loaders.cifar_loader import LabeledData
from ..nodes.images.core import (
    CenterCornerPatcher,
    GrayScaler,
    ImageVectorizer,
    PixelScaler,
    RandomImageTransformer,
    RandomPatcher,
)
from ..nodes.learning.block_ls import BlockLeastSquaresEstimator
from ..nodes.learning.kernels import KernelRidgeRegression
from ..nodes.learning.linear import LinearMapEstimator
from ..nodes.stats.scalers import StandardScaler
from ..nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from ..nodes.util.fusion import FusedBatchTransformer
from ..parallel.mesh import DATA_AXIS, axis_size, current_mesh
from ..utils.images import flip_horizontal
from .random_patch_cifar import (
    RandomPatchCifarConfig,
    _sync,
    fit_and_score,
    learn_filters,
    load_data,
    make_featurizer,
)

#: LinearPixels' microbatch, as the JAX package fixes it
#: (`cifar_variants.py:95-100`)
LINEAR_PIXELS_MICROBATCH = 4096


@dataclass
class LinearPixelsConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    lam: float = 1.0
    num_classes: int = 10
    synth_train: int = 1000
    synth_test: int = 250
    seed: int = 0


def linear_pixels_featurizer() -> FusedBatchTransformer:
    """Raw pixels → gray → flat rows, as one chain kernel launch per
    microbatch."""
    return FusedBatchTransformer(
        [PixelScaler(), GrayScaler(), ImageVectorizer()],
        microbatch=LINEAR_PIXELS_MICROBATCH)


def build_linear_pixels(train, config: LinearPixelsConfig):
    """Build + fit the LinearPixels predictor on ``train``."""
    featurizer = linear_pixels_featurizer().to_pipeline() >> Cacher("pixels")
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(
        train.labels).get()
    return featurizer.and_then(LinearMapEstimator(config.lam), train.data,
                               labels) >> MaxClassifier()


def analyzable(config: Optional[LinearPixelsConfig] = None,
               device="cuda"):
    """The LinearPixels predictor over abstract placeholder data, for
    static validation (`keystone_tpu/pipelines/cifar_variants.py:68-89`).
    It holds no weights before its fit, so ``device`` is unused. Returns
    ``(pipeline, source_spec)``."""
    from ..analysis import SpecDataset

    config = config or LinearPixelsConfig()
    h = w = 32
    c = 3
    n = 256
    feats = (FusedBatchTransformer([PixelScaler(), GrayScaler(),
                                    ImageVectorizer()], microbatch=4096)
             .to_pipeline() >> Cacher("pixels"))
    data = SpecDataset((h, w, c), np.float32, count=n, name="cifar-images")
    raw_labels = SpecDataset((), np.int32, count=n, name="cifar-labels")
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(raw_labels)
    predictor = feats.and_then(LinearMapEstimator(config.lam), data,
                               labels) >> MaxClassifier()
    return predictor, (h, w, c)


def run_linear_pixels(config: LinearPixelsConfig, device="cuda"):
    """Load or synthesize the data, fit LinearPixels, score train and
    test."""
    train, test = load_data(config, device)
    return fit_and_score(lambda: build_linear_pixels(train, config), train,
                         test, config.num_classes)


@dataclass
class RandomCifarConfig(RandomPatchCifarConfig):
    pass


def random_filters(config, channels: int = 3) -> np.ndarray:
    """(K, P·P·C) unit-norm Gaussian filters from numpy's
    ``default_rng(seed)``, as the JAX package draws them
    (`cifar_variants.py:124-127`)."""
    rng = np.random.default_rng(config.seed)
    d = config.patch_size * config.patch_size * channels
    filters = rng.normal(size=(config.num_filters, d)).astype(np.float32)
    return filters / np.linalg.norm(filters, axis=1, keepdims=True)


def _fit_scaled_bcd(featurizer, data, labels, config):
    """featurizer >> Cacher >> StandardScaler >> one BCD sweep, fit on
    ``data`` with int ``labels``: the scorer both RandomCifar and
    RandomPatchCifarAugmented fit (the JAX package fixes one sweep)."""
    indicators = ClassLabelIndicatorsFromInt(config.num_classes)(
        labels).get()
    return (
        (featurizer.to_pipeline() >> Cacher("features"))
        .and_then(StandardScaler(), data)
        .and_then(BlockLeastSquaresEstimator(config.block_size, 1,
                                             config.lam),
                  data, indicators)
    )


def build_random_cifar(train, config: RandomCifarConfig):
    """Build + fit the RandomCifar predictor on ``train``."""
    h, w, c = train.data.array.shape[1:]
    filters = torch.as_tensor(random_filters(config, c),
                              device=train.data.device)
    featurizer = make_featurizer(filters, None, h, w, c, config)
    return _fit_scaled_bcd(featurizer, train.data, train.labels,
                           config) >> MaxClassifier()


def run_random_cifar(config: RandomCifarConfig, device="cuda"):
    """Load or synthesize the data, fit RandomCifar, score train and
    test."""
    train, test = load_data(config, device)
    return fit_and_score(lambda: build_random_cifar(train, config), train,
                         test, config.num_classes)


@dataclass
class RandomPatchCifarKernelConfig(RandomPatchCifarConfig):
    gamma: float = 2e-3
    kernel_block: int = 2048
    kernel_epochs: int = 1


def build_random_patch_cifar_kernel(train,
                                    config: RandomPatchCifarKernelConfig,
                                    learned=None):
    """Build + fit the RandomPatchCifarKernel predictor on ``train``;
    ``learned``, given (filters, whitener), replaces filter learning."""
    filters, whitener = learned or learn_filters(train.data, config)
    h, w, c = train.data.array.shape[1:]
    featurizer = (make_featurizer(filters, whitener, h, w, c, config)
                  .to_pipeline() >> Cacher("features"))
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(
        train.labels).get()
    return (
        featurizer
        .and_then(StandardScaler(), train.data)
        .and_then(KernelRidgeRegression(config.gamma, config.lam,
                                        config.kernel_block,
                                        config.kernel_epochs),
                  train.data, labels)
        >> MaxClassifier()
    )


def run_random_patch_cifar_kernel(config: RandomPatchCifarKernelConfig,
                                  device="cuda", mesh=None):
    """Load or synthesize the data, fit RandomPatchCifarKernel, score
    train and test; on ``mesh`` (default the current one) each rank's
    rows."""
    train, test = load_data(config, device,
                            mesh if mesh is not None else current_mesh())
    return fit_and_score(
        lambda: build_random_patch_cifar_kernel(train, config), train, test,
        config.num_classes)


@dataclass
class RandomPatchCifarAugmentedConfig(RandomPatchCifarConfig):
    patches_per_image: int = 4
    aug_patch: int = 24


@dataclass
class RandomPatchCifarAugmentedKernelConfig(RandomPatchCifarConfig):
    patches_per_image: int = 4
    aug_patch: int = 24
    flip_chance: float = 0.5
    gamma: float = 2e-4
    kernel_block: int = 2048
    kernel_epochs: int = 1
    checkpoint_dir: Optional[str] = None
    blocks_before_checkpoint: int = 25


def augmented_featurizer(filters, whitener, config,
                         channels: int = 3) -> FusedBatchTransformer:
    """The featurizer over ``aug_patch``-square crops, pooled as the JAX
    package pools them: pool ap//2 at stride max(ap//2 − 1, 1), one
    window an axis at 24 (`cifar_variants.py:232, 323`)."""
    ap = config.aug_patch
    pooled = dataclasses.replace(config, pool_size=ap // 2,
                                 pool_stride=max(ap // 2 - 1, 1))
    return make_featurizer(filters, whitener, ap, ap, channels, pooled)


def _placed(rows: torch.Tensor, mesh=None) -> Dataset:
    """A `Dataset` of the whole ``rows``; on a mesh of more than one
    data shard, this rank's rows of it, copied out so the whole array
    can be freed."""
    if axis_size(mesh, DATA_AXIS) == 1:
        return Dataset(rows)
    mine = Dataset(rows, mesh=mesh)
    return Dataset(mine.array.clone(), count=mine.count, mesh=mesh,
                   placed=True)


def random_crops(train, config, mesh=None) -> LabeledData:
    """``patches_per_image`` random crops of every training image
    (`RandomPatcher`, seeded by ``config.seed``), each with its image's
    label; ``train`` whole, the views placed on ``mesh``."""
    crops = RandomPatcher(config.patches_per_image, config.aug_patch,
                          config.aug_patch, seed=config.seed
                          ).apply_batch(train.data)
    labels = train.labels.array[:train.labels.count].repeat_interleave(
        config.patches_per_image)
    return LabeledData(labels=_placed(labels, mesh),
                       data=_placed(crops.array, mesh))


def flipped_shuffled_crops(train, config, mesh=None) -> LabeledData:
    """`random_crops`, each flipped with probability ``flip_chance``
    (seed + 1), then images and labels shuffled by one numpy permutation
    (seed + 2) applied on the device (`cifar_variants.py:289-307`); all
    drawn over the whole ``train``, the views placed on ``mesh``."""
    crops = random_crops(train, config)
    images = RandomImageTransformer(config.flip_chance, flip_horizontal,
                                    seed=config.seed + 1
                                    ).apply_batch(crops.data)
    perm = np.random.default_rng(config.seed + 2).permutation(
        crops.data.count)
    perm = torch.as_tensor(perm, device=images.device)
    return LabeledData(labels=_placed(crops.labels.array[perm], mesh),
                       data=_placed(images.array[perm], mesh))


def _learned_augmented_featurizer(aug: LabeledData, config):
    """Filters learned on the crops and the featurizer over them."""
    filters, whitener = learn_filters(aug.data, config)
    return augmented_featurizer(filters, whitener, config,
                                aug.data.array.shape[-1])


def build_random_patch_cifar_augmented(
        aug: LabeledData, config: RandomPatchCifarAugmentedConfig):
    """Fit RandomPatchCifarAugmented's scorer (featurizer, scaler, BCD;
    no argmax: the test views' scores are averaged first) on training
    views ``aug``."""
    return _fit_scaled_bcd(_learned_augmented_featurizer(aug, config),
                           aug.data, aug.labels, config)


def build_random_patch_cifar_augmented_kernel(
        aug: LabeledData, config: RandomPatchCifarAugmentedKernelConfig):
    """Fit RandomPatchCifarAugmentedKernel's scorer (featurizer, scaler,
    kernel ridge regression; no argmax) on training views ``aug``."""
    featurizer = _learned_augmented_featurizer(aug, config).to_pipeline() \
        >> Cacher("features")
    indicators = ClassLabelIndicatorsFromInt(config.num_classes)(
        aug.labels).get()
    return (
        featurizer
        .and_then(StandardScaler(), aug.data)
        .and_then(KernelRidgeRegression(
            config.gamma, config.lam, config.kernel_block,
            config.kernel_epochs, seed=config.seed,
            checkpoint_dir=config.checkpoint_dir,
            blocks_before_checkpoint=config.blocks_before_checkpoint),
            aug.data, indicators)
    )


def center_corner_views(test, config, with_flips: bool, mesh=None):
    """(views, ids, labels): the centre and corner crops of every test
    image (and their flips), image-major, each row with its image's
    index and label; ``test`` whole, on ``mesh`` three placed
    datasets."""
    patcher = CenterCornerPatcher(config.aug_patch, config.aug_patch,
                                  with_flips=with_flips)
    views = patcher.apply_batch(test.data)
    n = test.data.count
    ids = torch.arange(n, device=views.device).repeat_interleave(
        patcher.views)
    labels = test.labels.array[:n].repeat_interleave(patcher.views)
    if axis_size(mesh, DATA_AXIS) == 1:
        return views, ids, labels
    return (_placed(views.array, mesh), _placed(ids, mesh),
            _placed(labels, mesh))


def score_center_corner_views(scorer, test, config, with_flips: bool,
                              mesh=None):
    """Test metrics: ``scorer``'s scores of the test views, averaged an
    image by `AugmentedExamplesEvaluator` (on ``mesh``, over every
    rank's views)."""
    views, ids, labels = center_corner_views(test, config, with_flips,
                                             mesh)
    return AugmentedExamplesEvaluator(config.num_classes)(
        ids, scorer(views), labels)


def fit_and_score_augmented(augment, build, train, test, config,
                            with_flips: bool, mesh=None):
    """Augment the training set with ``augment(train, config, mesh)``,
    fit with ``build(views, config)`` and score the training views and
    the test views. The train clock covers the augmentation, the fit and
    the training views' predict and evaluation, closed by a device sync;
    the rate counts training views. ``train`` and ``test`` are whole;
    on ``mesh`` the views are placed on its ranks."""
    dev = train.data.device
    _sync(dev)
    t0 = time.perf_counter()
    aug = augment(train, config, mesh)
    scorer = build(aug, config)
    train_metrics = MulticlassClassifierEvaluator(config.num_classes)(
        (scorer >> MaxClassifier())(aug.data), aug.labels)
    _sync(dev)
    t_train = time.perf_counter() - t0
    test_metrics = score_center_corner_views(scorer, test, config,
                                             with_flips, mesh)
    return {
        "train_error": train_metrics.error,
        "test_error": test_metrics.error,
        "test_accuracy": test_metrics.accuracy,
        "train_seconds": t_train,
        "train_views": aug.data.count,
        "images_per_sec": aug.data.count / t_train,
        "summary": test_metrics.summary(),
        "test_confusion": test_metrics.confusion,
        "scorer": scorer,
    }


def run_random_patch_cifar_augmented(config: RandomPatchCifarAugmentedConfig,
                                     device="cuda", mesh=None):
    """Load or synthesize the data, fit RandomPatchCifarAugmented on
    random crops, score five views a test image; on ``mesh`` (default
    the current one) the views placed on its ranks."""
    train, test = load_data(config, device)
    return fit_and_score_augmented(
        random_crops, build_random_patch_cifar_augmented, train, test,
        config, with_flips=False,
        mesh=mesh if mesh is not None else current_mesh())


def run_random_patch_cifar_augmented_kernel(
        config: RandomPatchCifarAugmentedKernelConfig, device="cuda",
        mesh=None):
    """Load or synthesize the data, fit RandomPatchCifarAugmentedKernel
    on flipped, shuffled crops, score ten views a test image; on
    ``mesh`` (default the current one) the views placed on its ranks."""
    train, test = load_data(config, device)
    return fit_and_score_augmented(
        flipped_shuffled_crops, build_random_patch_cifar_augmented_kernel,
        train, test, config, with_flips=True,
        mesh=mesh if mesh is not None else current_mesh())


#: each CLI choice: its config, its run function, and the options it
#: takes beyond the common ones
PIPELINES = {
    "linear-pixels": (LinearPixelsConfig, run_linear_pixels, ()),
    "random-cifar": (RandomCifarConfig, run_random_cifar, ("num_filters",)),
    "kernel": (RandomPatchCifarKernelConfig, run_random_patch_cifar_kernel,
               ("num_filters", "gamma", "kernel_block", "kernel_epochs")),
    "augmented": (RandomPatchCifarAugmentedConfig,
                  run_random_patch_cifar_augmented,
                  ("num_filters", "patches_per_image", "aug_patch")),
    "augmented-kernel": (RandomPatchCifarAugmentedKernelConfig,
                         run_random_patch_cifar_augmented_kernel,
                         ("num_filters", "patches_per_image", "aug_patch",
                          "flip_chance", "gamma", "kernel_block",
                          "kernel_epochs", "checkpoint_dir",
                          "blocks_before_checkpoint")),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pipeline", choices=tuple(PIPELINES))
    p.add_argument("--train-path", dest="train_path")
    p.add_argument("--test-path", dest="test_path")
    p.add_argument("--lam", type=float)
    p.add_argument("--synth-train", dest="synth_train", type=int)
    p.add_argument("--synth-test", dest="synth_test", type=int)
    p.add_argument("--seed", type=int)
    for flag, kind in (("num-filters", int), ("patches-per-image", int),
                       ("aug-patch", int), ("flip-chance", float),
                       ("gamma", float), ("kernel-block", int),
                       ("kernel-epochs", int), ("checkpoint-dir", str),
                       ("blocks-before-checkpoint", int)):
        dest = flag.replace("-", "_")
        users = [k for k, v in PIPELINES.items() if dest in v[2]]
        p.add_argument(f"--{flag}", dest=dest, type=kind,
                       help=f"{', '.join(users)} only")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = vars(p.parse_args(argv))
    pipeline, device = args.pop("pipeline"), args.pop("device")
    config_cls, run_fn, own = PIPELINES[pipeline]
    given = {k: v for k, v in args.items() if v is not None}
    common = {"train_path", "test_path", "lam", "synth_train", "synth_test",
              "seed"}
    foreign = set(given) - common - set(own)
    if foreign:
        p.error(f"{pipeline} takes no {sorted(foreign)}")
    result = run_fn(config_cls(**given), device)
    print(result["summary"])
    print(f"train_error={result['train_error']:.4f} "
          f"test_error={result['test_error']:.4f} "
          f"train_time={result['train_seconds']:.2f}s "
          f"({result['images_per_sec']:.0f} img/s)")
    return result


if __name__ == "__main__":
    main()
