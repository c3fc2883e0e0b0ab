"""MnistRandomFFT on one CUDA card.

Counterpart of `keystone_tpu/pipelines/mnist_random_fft.py` (`:31-143`;
reference pipelines/images/mnist/MnistRandomFFT.scala:18-114):
``num_ffts`` branches of RandomSignNode (seed ``seed + i``) >> PaddedFFT
>> LinearRectifier(0), gathered and concatenated, then
`BlockLeastSquaresEstimator` (one sweep) and `MaxClassifier`, scored by
the multiclass evaluator.

The pipeline is built as JAX builds it, `Pipeline.gather(branches) >>
VectorCombiner()`, and the optimizer's fusion pass
(`workflow/fusion_rule.py::NodeFusionRule`) fuses each branch into a
`FusedBatchTransformer`, then the gather pass collapses the fan-out and
its `VectorCombiner` into one `_GatherConcatStage` inside a
`FusedBatchTransformer` of 2048-row microbatches: each microbatch's
branches write their columns of the feature rows, allocated once. CSE
shares the training featurization between the fit and the training
predict. The FFT runs on cuFFT through `torch.fft`; no chain kernel is
planned (`PaddedFFT` is a named suppression).

Data: a label-first CSV (the reference's MNIST format) from
``--train-path``/``--test-path``; without paths, scikit-learn's bundled
digits, split 80/20 by a numpy permutation. `run_on` takes given
`LabeledData`.

    python -m keystone_tpu_torch.pipelines.mnist_random_fft --device cpu
    python -m keystone_tpu_torch.pipelines.mnist_random_fft \\
        --train-path train.csv --test-path test.csv
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..evaluation import MulticlassClassifierEvaluator
from ..loaders.csv_loader import LabeledData
from ..nodes.learning.block_ls import BlockLeastSquaresEstimator
from ..nodes.stats.random_features import (
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
)
from ..nodes.util.basic import (
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
    VectorCombiner,
)
from ..workflow.pipeline import Pipeline
from .random_patch_cifar import _sync


@dataclass
class MnistRandomFFTConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_ffts: int = 4
    block_size: int = 2048
    lam: float = 1e-4
    num_classes: int = 10
    seed: int = 0


def _load(config: MnistRandomFFTConfig, device) -> tuple:
    """(train, test) from the CSV paths, or scikit-learn's digits."""
    if config.train_path:
        return (LabeledData.label_featured_csv(config.train_path,
                                               device=device),
                LabeledData.label_featured_csv(
                    config.test_path or config.train_path, device=device))
    from sklearn.datasets import load_digits

    digits = load_digits()
    X = (digits.data / 16.0).astype(np.float32)
    y = digits.target.astype(np.int32)
    n_train = int(0.8 * len(X))
    perm = np.random.default_rng(0).permutation(len(X))
    tr, te = perm[:n_train], perm[n_train:]
    return (LabeledData.from_arrays(y[tr], X[tr], device),
            LabeledData.from_arrays(y[te], X[te], device))


def featurizer(dim: int, config: MnistRandomFFTConfig, device) -> Pipeline:
    """The gather of the ``num_ffts`` branch chains (branch ``i`` seeded
    ``seed + i``) and its combiner (`:70-76`)."""
    branches = [RandomSignNode(dim, seed=config.seed + i, device=device)
                >> PaddedFFT() >> LinearRectifier(0.0)
                for i in range(config.num_ffts)]
    return Pipeline.gather(branches) >> VectorCombiner()


def build(train: LabeledData, config: MnistRandomFFTConfig):
    """featurizer >> BCD (fit lazily on ``train``) >> MaxClassifier."""
    dim = train.data.array.shape[1]
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(
        train.labels).get()
    return featurizer(dim, config, train.data.device).and_then(
        BlockLeastSquaresEstimator(config.block_size, num_iter=1,
                                   lam=config.lam),
        train.data, labels) >> MaxClassifier()


def run_on(train: LabeledData, test: LabeledData,
           config: MnistRandomFFTConfig) -> dict:
    """Build the predictor, then score train and test. ``seconds`` covers
    both predicts and evaluations, the lazy fit with them, closed by a
    device sync, as the JAX package's clock (`:112-116`)."""
    if config.num_ffts < 1:
        raise ValueError("--num-ffts must be >= 1")
    predictor = build(train, config)
    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    dev = train.data.device
    _sync(dev)
    t0 = time.perf_counter()
    train_eval = evaluator(predictor(train.data), train.labels)
    test_eval = evaluator(predictor(test.data), test.labels)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    return {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "test_accuracy": test_eval.accuracy,
        "seconds": elapsed,
        "rows_per_sec": (train.data.count + test.data.count) / elapsed,
        "summary": test_eval.summary(),
        "predictor": predictor,
    }


def analyzable(config: Optional[MnistRandomFFTConfig] = None,
               device: DeviceLike = "cuda"):
    """The predictor graph over abstract placeholder data, for static
    validation (`keystone_tpu/pipelines/mnist_random_fft.py:62-86`): no
    data loads and no fit runs; the random signs live on ``device``.
    Returns ``(pipeline, source_spec)``."""
    from ..analysis import SpecDataset

    config = config or MnistRandomFFTConfig(num_ffts=2)
    dim, n = 64, 256
    branches = [
        RandomSignNode(dim, seed=config.seed + i, device=device)
        >> PaddedFFT()
        >> LinearRectifier(0.0)
        for i in range(config.num_ffts)
    ]
    feats = Pipeline.gather(branches) >> VectorCombiner()
    data = SpecDataset((dim,), np.float32, count=n, name="mnist-data")
    raw_labels = SpecDataset((), np.int32, count=n, name="mnist-labels")
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(raw_labels)
    predictor = feats.and_then(
        BlockLeastSquaresEstimator(min(config.block_size, dim), num_iter=1,
                                   lam=config.lam),
        data, labels) >> MaxClassifier()
    return predictor, (dim,)


def run(config: MnistRandomFFTConfig, device: DeviceLike = "cuda") -> dict:
    """Load the data (`_load`), fit and score on ``device``."""
    device = resolve_device(device)
    train, test = _load(config, device)
    return run_on(train, test, config)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train-path", dest="train_path")
    p.add_argument("--test-path", dest="test_path")
    p.add_argument("--num-ffts", dest="num_ffts", type=int, default=4)
    p.add_argument("--block-size", dest="block_size", type=int, default=2048)
    p.add_argument("--lam", type=float, default=1e-4)
    p.add_argument("--num-classes", dest="num_classes", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = vars(p.parse_args(argv))
    device = args.pop("device")
    result = run(MnistRandomFFTConfig(**args), device)
    print(result["summary"])
    print(f"train_error={result['train_error']:.4f} "
          f"test_error={result['test_error']:.4f} "
          f"time={result['seconds']:.2f}s")
    return result


if __name__ == "__main__":
    main()
