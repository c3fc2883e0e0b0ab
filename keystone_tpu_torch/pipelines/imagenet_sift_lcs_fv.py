"""ImageNetSiftLcsFV on one CUDA card.

Counterpart of `keystone_tpu/pipelines/imagenet_sift_lcs_fv.py`
(`:34-180`; reference pipelines/images/imagenet/ImageNetSiftLcsFV.scala:
1-228): two descriptor branches over the scaled images, dense SIFT
(grayscale, step 6, 2 scales) and LCS (stride 6), each with its own
ColumnPCA → GMM Fisher vector → MatrixVectorizer >> SignedHellingerMapper
>> NormalizeRows encoding, gathered (`Pipeline.gather` over the
`HostDataset`) and concatenated per image, stacked, then class-weighted
BCD and `MaxClassifier`, scored by the multiclass evaluator. A `Cacher`
after the scaled images and after each branch's descriptors shares them
between the samples and the solver's features, as the JAX graph
executor's prefix memo does.

Data: `_synthetic_imagenet`, a numpy-identical copy of the JAX package's
48×48 stand-in (`:47-57`), ``n_synth`` training and ``n_synth // 3``
test images. The ImageNet loader is not ported yet, so ``--train-tar``
raises. `run_on` takes given `HostDataset`s.

    python -m keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv --device cpu
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.dataset import Dataset, HostDataset, ZippedHostDataset
from ..device import DeviceLike, resolve_device
from ..evaluation import MulticlassClassifierEvaluator
from ..nodes.images.core import GrayScaler, PixelScaler
from ..nodes.images.descriptors import LCSExtractor
from ..nodes.images.extractors import ImageExtractor
from ..nodes.images.fisher_vector import GMMFisherVectorEstimator
from ..nodes.images.sift import SIFTExtractor
from ..nodes.learning.pca import ColumnPCAEstimator
from ..nodes.learning.weighted_ls import BlockWeightedLeastSquaresEstimator
from ..nodes.stats.normalization import (
    ColumnSampler,
    NormalizeRows,
    SignedHellingerMapper,
)
from ..nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MatrixVectorizer,
    MaxClassifier,
)
from ..loaders.image_loaders import imagenet_loader
from ..parallel.mesh import current_mesh
from ..utils.images import LabeledImage
from ..workflow.pipeline import Pipeline, Transformer
from .random_patch_cifar import _sync
from .voc_sift_fisher import (
    BWLS_BLOCK,
    BWLS_PASSES,
    _Stack,
)


@dataclass
class ImageNetSiftLcsFVConfig:
    train_tar: Optional[str] = None
    labels_map_csv: Optional[str] = None
    test_tar: Optional[str] = None
    num_classes: int = 10
    pca_dims: int = 32
    gmm_k: int = 8
    descriptor_samples: int = 100
    lam: float = 0.5
    n_synth: int = 60
    seed: int = 0


def _synthetic_imagenet(n: int, num_classes: int, noise_seed: int,
                        class_seed: int = 1234) -> HostDataset:
    """``n`` 48×48 RGB images, a class template plus noise, clipped to
    [0, 255] (`:47-57`, the same numpy draws)."""
    crng = np.random.default_rng(class_seed)
    templates = crng.uniform(0, 255, size=(num_classes, 48, 48, 3)).astype(
        np.float32)
    rng = np.random.default_rng(noise_seed)
    items = []
    for _ in range(n):
        c = int(rng.integers(num_classes))
        img = templates[c] + 25.0 * rng.normal(size=(48, 48, 3)).astype(
            np.float32)
        items.append(LabeledImage(np.clip(img, 0, 255), c))
    return HostDataset(items)


class _Concat(Transformer):
    """Each image's branch outputs flattened and joined, in branch order;
    over a zipped `HostDataset` each branch is stacked once and the
    columns are joined in one call."""

    def apply(self, xs):
        return torch.cat([torch.as_tensor(x).reshape(-1) for x in xs])

    def apply_batch(self, data):
        if not isinstance(data, ZippedHostDataset):
            return data.map(self.apply)
        n = len(data)
        joined = torch.cat([p.stack().array[:n].reshape(n, -1)
                            for p in data.parts], dim=1)
        return HostDataset.from_buckets([(list(range(n)), joined)], n,
                                        data.device)


def _fv_branch(base: Pipeline, train: HostDataset,
               config: ImageNetSiftLcsFVConfig) -> Pipeline:
    """descriptors → PCA → GMM Fisher vector → normalized (`:68-78`)."""
    base = base >> Cacher()
    sampled = (base >> ColumnSampler(config.descriptor_samples))(train)
    pca = base.and_then(ColumnPCAEstimator(config.pca_dims).with_data(
        sampled))
    fv_sample = (pca >> ColumnSampler(config.descriptor_samples))(train)
    return (pca.and_then(GMMFisherVectorEstimator(config.gmm_k).with_data(
        fv_sample)) >> MatrixVectorizer() >> SignedHellingerMapper()
        >> NormalizeRows())


class _Image(Transformer):
    """A `LabeledImage`'s image: the request boundary the serving
    certifier declares for this pipeline (`keystone_tpu/pipelines/
    imagenet_sift_lcs_fv.py:60-65`)."""

    def apply(self, x):
        return x.image

    def apply_batch(self, data):
        return HostDataset([x.image for x in data.items])


def analyzable(config: Optional[ImageNetSiftLcsFVConfig] = None,
               device: DeviceLike = "cuda"):
    """The dual-branch (SIFT + LCS) predictor over abstract placeholder
    data, for static validation (`keystone_tpu/pipelines/
    imagenet_sift_lcs_fv.py:81-110`): the JAX package's graph, whose
    branches hold no `Cacher`. It holds no weights before its fits, so
    ``device`` is unused. Returns ``(pipeline, source_spec)``."""
    from ..analysis import SpecDataset

    config = config or ImageNetSiftLcsFVConfig()
    n = 64
    train = SpecDataset(count=n, name="imagenet-images", on_device=False)
    img = _Image().to_pipeline() >> PixelScaler()

    def branch(base):
        sampled = (base >> ColumnSampler(config.descriptor_samples)).apply(
            train)
        pca = base.and_then(ColumnPCAEstimator(config.pca_dims).with_data(
            sampled))
        fv_sample = (pca >> ColumnSampler(config.descriptor_samples)).apply(
            train)
        return (pca.and_then(GMMFisherVectorEstimator(config.gmm_k)
                             .with_data(fv_sample))
                >> MatrixVectorizer() >> SignedHellingerMapper()
                >> NormalizeRows())

    sift_branch = branch(img >> GrayScaler()
                         >> SIFTExtractor(step=6, num_scales=2))
    lcs_branch = branch(img >> LCSExtractor(stride=6))
    feats = Pipeline.gather([sift_branch, lcs_branch]) >> _Concat() >> _Stack()
    raw_labels = SpecDataset((), np.int32, count=n, name="imagenet-labels")
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(raw_labels)
    predictor = feats.and_then(
        BlockWeightedLeastSquaresEstimator(4096, 1, config.lam), train,
        labels) >> MaxClassifier()
    return predictor, None


def build(train: HostDataset, config: ImageNetSiftLcsFVConfig,
          device: DeviceLike = "cuda") -> Pipeline:
    """gather(SIFT branch, LCS branch) >> _Concat >> _Stack >> BWLS >>
    MaxClassifier over ``train`` (`:139-160`); fit at first use."""
    dev = resolve_device(device)
    img = ImageExtractor().to_pipeline() >> PixelScaler() >> Cacher()
    sift_branch = _fv_branch(
        img >> GrayScaler() >> SIFTExtractor(step=6, num_scales=2), train,
        config)
    lcs_branch = _fv_branch(img >> LCSExtractor(stride=6), train, config)
    featurizer = (Pipeline.gather([sift_branch, lcs_branch]) >> _Concat()
                  >> _Stack())
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(Dataset(
        np.asarray(train.map(lambda x: x.label).gather_items(), np.int32),
        device=dev, mesh=train.mesh)).get()
    return featurizer.and_then(
        BlockWeightedLeastSquaresEstimator(BWLS_BLOCK, BWLS_PASSES,
                                           config.lam),
        train, labels) >> MaxClassifier()


def run_on(train: HostDataset, test: HostDataset,
           config: ImageNetSiftLcsFVConfig,
           device: DeviceLike = "cuda", mesh=None) -> dict:
    """Build, fit on ``train`` and evaluate on ``test``; ``seconds`` runs
    from the build to the test evaluation, closed by a device sync, as
    the JAX package's clock (`:139-172`). On ``mesh`` (a data axis of
    more than one rank; every rank passes all the images) each rank
    featurizes its share of the images (`HostDataset.on_mesh`), the
    PCA, GMM and BWLS fits see every rank's rows, ``predictions`` are
    this rank's rows, and the accuracy counts every rank's test
    images."""
    dev = resolve_device(device)
    train = HostDataset.on_mesh(train.items, mesh, device=dev)
    test = HostDataset.on_mesh(test.items, mesh, device=dev)
    if test.mesh is None:
        actuals = [x.label for x in test.items]
    else:
        actuals = Dataset(np.asarray(
            test.map(lambda x: x.label).gather_items(), np.int32),
            device=dev, mesh=test.mesh)
    _sync(dev)
    t0 = time.perf_counter()
    predictor = build(train, config, dev)
    predictions = predictor(test).get()
    test_eval = MulticlassClassifierEvaluator(config.num_classes)(
        predictions, actuals)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    return {"test_accuracy": test_eval.accuracy,
            "test_error": test_eval.error, "seconds": elapsed,
            "images_per_sec": (train.total + test.total) / elapsed,
            "predictions": predictions, "predictor": predictor}


def run(config: ImageNetSiftLcsFVConfig,
        device: DeviceLike = "cuda", mesh=None) -> dict:
    """Fit and score on ``device``: the images of ``train_tar`` and
    ``test_tar`` (default: the train tar), labelled through the
    ``synset,label`` rows of ``labels_map_csv`` and decoded by
    `loaders/image_loaders.py::imagenet_loader` onto ``device``
    (`:114-121`); without a tar, the synthetic images at ``n_synth`` and
    ``n_synth // 3``. On ``mesh`` (default the current one: none in
    one process) each rank featurizes its share (`run_on`)."""
    device = resolve_device(device)
    if config.train_tar:
        labels_map = read_labels_map(config.labels_map_csv)
        train = imagenet_loader(config.train_tar, labels_map, device=device)
        test = imagenet_loader(config.test_tar or config.train_tar,
                               labels_map, device=device)
    else:
        train = _synthetic_imagenet(config.n_synth, config.num_classes,
                                    config.seed)
        test = _synthetic_imagenet(config.n_synth // 3, config.num_classes,
                                   config.seed + 1)
    return run_on(train, test, config, device,
                  mesh if mesh is not None else current_mesh())


def read_labels_map(path: str) -> dict:
    """``synset,label`` rows → synset → label (`:115-119`)."""
    labels_map = {}
    with open(path) as f:
        for line in f:
            syn, lab = line.strip().split(",")
            labels_map[syn] = int(lab)
    return labels_map


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train-tar")
    p.add_argument("--labels-map-csv")
    p.add_argument("--test-tar")
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--n-synth", type=int, default=60)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = vars(p.parse_args(argv))
    device = args.pop("device")
    config = ImageNetSiftLcsFVConfig(
        **{k: v for k, v in args.items() if v is not None})
    result = run(config, device)
    print(f"accuracy={result['test_accuracy']:.4f} "
          f"time={result['seconds']:.1f}s")
    return result


if __name__ == "__main__":
    main()
