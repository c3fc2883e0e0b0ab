"""VOCSIFTFisher on one CUDA card.

Counterpart of `keystone_tpu/pipelines/voc_sift_fisher.py` (`:34-237`;
reference pipelines/images/voc/VOCSIFTFisher.scala:23-157):
MultiLabeledImageExtractor >> PixelScaler >> GrayScaler >> dense SIFT
(step 6, 2 scales) → ColumnPCA fit on ``descriptor_samples`` sampled
descriptors an image → GMM Fisher vectors (k components, fit on sampled
projected descriptors) → MatrixVectorizer >> SignedHellingerMapper >>
NormalizeRows on each image → stacked → class-weighted BCD (block 4096,
one pass) → scores, evaluated by mean average precision. Or the PCA and
the GMM come from the reference's sideband CSVs (``--pca-file``,
``--gmm-{mean,var,wts}-file``) and are not fit.

On a mesh (JAX fits the same graph on row-sharded data) every rank
holds its share of the images; SIFT, the gray chain and the Fisher-vector
tail (K4) run on its images, the PCA and GMM fits collect one process's
sample from every rank (`pca.collect_rows`), BWLS all-reduces its sums
and Grams, and the mAP is computed over every rank's scores.

The images are a `HostDataset`; each stage runs once a bucket of
equal-shape images on the device, and the descriptors, projections and
Fisher vectors stay there. The per-image stages of the Fisher vector
(vectorize, signed square root, L2) run before the stack, as in the JAX
package, so no elementwise chain kernel is planned. The JAX graph
executor computes the SIFT prefix once for the PCA sample, the GMM sample
and the solver's features; here a `Cacher` after SIFT does.

Data: `_synthetic_voc`, a numpy-identical copy of the JAX package's
48×48 stand-in (`:56-69`), ``n_synth`` training and ``n_synth // 3``
test images. The VOC image loader is not ported yet, so ``--train-tar``
raises. `run_on` takes given `HostDataset`s.

    python -m keystone_tpu_torch.pipelines.voc_sift_fisher --device cpu
    python -m keystone_tpu_torch.pipelines.voc_sift_fisher --n-synth 600 \\
        --pca-dims 80 --gmm-k 256
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..data.dataset import Dataset, HostDataset
from ..device import DeviceLike, resolve_device
from ..evaluation.map_evaluator import MeanAveragePrecisionEvaluator
from ..nodes.images.core import GrayScaler, PixelScaler
from ..nodes.images.extractors import MultiLabeledImageExtractor
from ..nodes.images.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
)
from ..nodes.images.sift import SIFTExtractor
from ..nodes.learning.gmm import GaussianMixtureModel
from ..nodes.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from ..nodes.learning.weighted_ls import BlockWeightedLeastSquaresEstimator
from ..nodes.stats.normalization import (
    ColumnSampler,
    NormalizeRows,
    SignedHellingerMapper,
)
from ..nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromIntArray,
    MatrixVectorizer,
)
from ..loaders.image_loaders import voc_loader
from ..parallel.mesh import current_mesh
from ..utils.images import MultiLabeledImage
from ..workflow.pipeline import Pipeline, Transformer
from .random_patch_cifar import _sync

#: the solver's block and passes (`:166-181`)
BWLS_BLOCK, BWLS_PASSES = 4096, 1

@dataclass
class VOCSIFTFisherConfig:
    train_tar: Optional[str] = None
    train_labels: Optional[str] = None
    test_tar: Optional[str] = None
    test_labels: Optional[str] = None
    num_classes: int = 20
    pca_dims: int = 64
    gmm_k: int = 16
    descriptor_samples: int = 100
    lam: float = 0.5
    mixture_weight: float = 0.5
    n_synth: int = 60
    seed: int = 0
    # sideband model files (reference --pcaFile / --gmmMeanFile /
    # --gmmVarFile / --gmmWtsFile, VOCSIFTFisher.scala:49-67): when set,
    # the fit is skipped and the model read from CSV
    pca_file: Optional[str] = None
    gmm_mean_file: Optional[str] = None
    gmm_var_file: Optional[str] = None
    gmm_wts_file: Optional[str] = None


def _synthetic_voc(n: int, num_classes: int, noise_seed: int,
                   class_seed: int = 1234) -> HostDataset:
    """``n`` 48×48 RGB images, each the mean of its one or two classes'
    templates plus noise, clipped to [0, 255] (`:56-69`, the same numpy
    draws)."""
    crng = np.random.default_rng(class_seed)
    templates = crng.uniform(0, 255, size=(num_classes, 48, 48, 3)).astype(
        np.float32)
    rng = np.random.default_rng(noise_seed)
    items = []
    for _ in range(n):
        labs = sorted(set(rng.integers(0, num_classes,
                                       size=rng.integers(1, 3)).tolist()))
        img = np.zeros((48, 48, 3), np.float32)
        for lab in labs:
            img += templates[lab] / len(labs)
        img += 20.0 * rng.normal(size=img.shape).astype(np.float32)
        items.append(MultiLabeledImage(np.clip(img, 0, 255), labs))
    return HostDataset(items)


class _Stack(Transformer):
    """HostDataset of equal-length vectors → device Dataset."""

    def apply(self, x):
        return x

    def apply_batch(self, data):
        if isinstance(data, HostDataset):
            return data.stack(dtype=torch.float32)
        return data


def _label_lists(ds: HostDataset) -> list:
    """Each image's class ids, every rank's images on a mesh."""
    return ds.map(lambda x: list(x.labels)).gather_items()


def _pad_labels(ds: HostDataset, num_classes: int) -> np.ndarray:
    """Each image's class ids, padded with −1 to the longest list (on a
    mesh, every rank's images)."""
    lists = _label_lists(ds)
    max_l = max(len(x) for x in lists)
    out = -np.ones((len(lists), max_l), np.int32)
    for i, x in enumerate(lists):
        out[i, :len(x)] = x
    return out


@dataclass
class VOCModel:
    """The pipeline's parts: ``sift`` (images → descriptors, cached);
    ``pca`` and ``fisher``, each a pipeline that ends in its lazily fit
    estimator (`Pipeline.fitted` fits it and gives the transformer) or
    the transformer read from the sideband files; ``featurizer`` (images
    → stacked Fisher vectors) and ``predictor`` (images → scores), whose
    `fitted()` is the BWLS model."""

    sift: Pipeline
    pca: Union[Pipeline, Transformer]
    fisher: Union[Pipeline, Transformer]
    featurizer: Pipeline
    predictor: Pipeline


def build(train: HostDataset, config: VOCSIFTFisherConfig,
          device: DeviceLike = "cuda") -> VOCModel:
    """The VOCSIFTFisher predictor over ``train`` (`:127-185`); nothing
    is fit until it runs."""
    dev = resolve_device(device)
    sift = (MultiLabeledImageExtractor().to_pipeline() >> PixelScaler()
            >> GrayScaler() >> SIFTExtractor(step=6, num_scales=2)
            >> Cacher("voc-sift"))
    if config.pca_file:
        # the reference's sideband layout is (k × d), csvread(...).t
        # (VOCSIFTFisher.scala:52)
        pca_node = BatchPCATransformer(torch.tensor(
            np.loadtxt(config.pca_file, delimiter=",", ndmin=2).T,
            dtype=torch.float32, device=dev))
        pca_featurizer = sift >> pca_node
    else:
        sampled = (sift >> ColumnSampler(config.descriptor_samples))(train)
        pca_featurizer = sift.and_then(
            ColumnPCAEstimator(config.pca_dims).with_data(sampled))
        pca_node = pca_featurizer
    if config.gmm_mean_file:
        if not (config.gmm_var_file and config.gmm_wts_file):
            raise ValueError("--gmm-mean-file requires --gmm-var-file and "
                             "--gmm-wts-file")
        fisher = FisherVector(GaussianMixtureModel.load_csv(
            config.gmm_mean_file, config.gmm_var_file, config.gmm_wts_file,
            device=dev))
    else:
        fisher_sample = (pca_featurizer
                         >> ColumnSampler(config.descriptor_samples))(train)
        fisher = GMMFisherVectorEstimator(config.gmm_k).with_data(
            fisher_sample)
    featurizer = (pca_featurizer.and_then(fisher) >> MatrixVectorizer()
                  >> SignedHellingerMapper() >> NormalizeRows() >> _Stack())
    labels = ClassLabelIndicatorsFromIntArray(config.num_classes)(
        Dataset(_pad_labels(train, config.num_classes), device=dev,
                mesh=train.mesh)).get()
    predictor = featurizer.and_then(
        BlockWeightedLeastSquaresEstimator(BWLS_BLOCK, BWLS_PASSES,
                                           config.lam,
                                           config.mixture_weight),
        train, labels)
    return VOCModel(sift, pca_node, fisher, featurizer, predictor)


def analyzable(config: Optional[VOCSIFTFisherConfig] = None,
               device: DeviceLike = "cuda"):
    """The VOC predictor over abstract placeholder data, for static
    validation (`keystone_tpu/pipelines/voc_sift_fisher.py:72-112`): the
    SIFT → PCA → Fisher vector → solver graph of the JAX package (without
    this module's `Cacher`); the host image stages propagate UNKNOWN. It
    holds no weights before its fits, so ``device`` is unused. Returns
    ``(pipeline, source_spec)``."""
    from ..analysis import SpecDataset

    config = config or VOCSIFTFisherConfig()
    n = 64
    train = SpecDataset(count=n, name="voc-images", on_device=False)
    sift = (MultiLabeledImageExtractor().to_pipeline() >> PixelScaler()
            >> GrayScaler() >> SIFTExtractor(step=6, num_scales=2))
    sampled = (sift >> ColumnSampler(config.descriptor_samples)).apply(train)
    pca_featurizer = sift.and_then(
        ColumnPCAEstimator(config.pca_dims).with_data(sampled))
    fisher_sample = (pca_featurizer
                     >> ColumnSampler(config.descriptor_samples)).apply(train)
    fisher = GMMFisherVectorEstimator(config.gmm_k).with_data(fisher_sample)
    feats = (pca_featurizer.and_then(fisher) >> MatrixVectorizer()
             >> SignedHellingerMapper() >> NormalizeRows() >> _Stack())
    labels = SpecDataset((config.num_classes,), np.float32, count=n,
                         name="voc-labels")
    predictor = feats.and_then(
        BlockWeightedLeastSquaresEstimator(4096, 1, config.lam,
                                           config.mixture_weight),
        train, labels)
    return predictor, None


def run_on(train: HostDataset, test: HostDataset,
           config: VOCSIFTFisherConfig, device: DeviceLike = "cuda",
           mesh=None) -> dict:
    """Build the predictor, fit it on ``train`` and score ``test``.
    ``seconds`` runs from the build to the test scores, closed by a
    device sync, as the JAX package's clock (`:124-185`); mAP comes
    after it. On ``mesh`` (a data axis of more than one rank; every
    rank passes all the images) each rank runs SIFT and the Fisher
    vectors on its share of the images (`HostDataset.on_mesh`), the
    PCA, GMM and BWLS fits see every rank's rows, ``scores`` are this
    rank's rows, and the mAP ranks every rank's."""
    dev = resolve_device(device)
    train = HostDataset.on_mesh(train.items, mesh, device=dev)
    test = HostDataset.on_mesh(test.items, mesh, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    model = build(train, config, dev)
    scores = model.predictor(test).get()
    _sync(dev)
    elapsed = time.perf_counter() - t0
    aps = MeanAveragePrecisionEvaluator(config.num_classes)(
        scores, _label_lists(test))
    return {"map": float(aps.mean()), "aps": aps.tolist(),
            "seconds": elapsed,
            "images_per_sec": (train.total + test.total) / elapsed,
            "scores": scores, "model": model}


def run(config: VOCSIFTFisherConfig, device: DeviceLike = "cuda",
        mesh=None) -> dict:
    """Fit and score on ``device``: the images of ``train_tar`` (labels
    ``train_labels``) and ``test_tar`` (default: the train tar and
    labels), decoded by `loaders/image_loaders.py::voc_loader` onto
    ``device`` (`:116-119`); without a tar, the synthetic images at
    ``n_synth`` and ``n_synth // 3``. On ``mesh`` (default the current
    one: none in one process) each rank featurizes its share of the
    images (`run_on`)."""
    device = resolve_device(device)
    if config.train_tar:
        train = voc_loader(config.train_tar, config.train_labels,
                           config.num_classes, device=device)
        test = voc_loader(config.test_tar or config.train_tar,
                          config.test_labels or config.train_labels,
                          config.num_classes, device=device)
    else:
        train = _synthetic_voc(config.n_synth, config.num_classes,
                               config.seed)
        test = _synthetic_voc(config.n_synth // 3, config.num_classes,
                              config.seed + 1)
    return run_on(train, test, config, device,
                  mesh if mesh is not None else current_mesh())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train-tar")
    p.add_argument("--train-labels")
    p.add_argument("--test-tar")
    p.add_argument("--test-labels")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--pca-dims", type=int, default=64)
    p.add_argument("--gmm-k", type=int, default=16)
    p.add_argument("--lam", type=float, default=0.5)
    p.add_argument("--n-synth", type=int, default=60)
    p.add_argument("--pca-file")
    p.add_argument("--gmm-mean-file")
    p.add_argument("--gmm-var-file")
    p.add_argument("--gmm-wts-file")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = vars(p.parse_args(argv))
    device = args.pop("device")
    config = VOCSIFTFisherConfig(
        **{k: v for k, v in args.items() if v is not None})
    result = run(config, device)
    print(f"mAP={result['map']:.4f} time={result['seconds']:.1f}s")
    return result


if __name__ == "__main__":
    main()
