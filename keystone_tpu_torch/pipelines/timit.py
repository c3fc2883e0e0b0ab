"""TimitPipeline on one CUDA card.

Counterpart of `keystone_tpu/pipelines/timit.py` (`:23-152`; reference
pipelines/speech/TimitPipeline.scala:1-148): pre-featurized TIMIT frames
→ `CosineRandomFeatures` (Gaussian or Cauchy, numpy-drawn from the seed)
→ `Cacher` → `BlockLeastSquaresEstimator` (``num_epochs`` sweeps over
``block_size`` columns) → `MaxClassifier`, scored by the multiclass
evaluator.

Data: the features CSV and the sparse ``index,label`` file of the
reference (`loaders.text_loaders.timit_loader`); without them,
`synthetic_timit`, a numpy-identical copy of the JAX package's stand-in
(`:42-52`) at ``n_synth`` train and ``n_synth // 4`` test frames, its
classes capped at 12. `run_on` takes given `LabeledData`.

    python -m keystone_tpu_torch.pipelines.timit --device cpu --n-synth 1500
    python -m keystone_tpu_torch.pipelines.timit --train-features f.csv \\
        --train-labels l.csv
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
from ..loaders.text_loaders import timit_loader
from ..nodes.learning.block_ls import BlockLeastSquaresEstimator
from ..nodes.stats.random_features import CosineRandomFeatures
from ..nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from .random_patch_cifar import _sync

#: classes of the synthetic stand-in (`:93`)
SYNTH_MAX_CLASSES = 12


@dataclass
class TimitConfig:
    train_features: Optional[str] = None
    train_labels: Optional[str] = None
    test_features: Optional[str] = None
    test_labels: Optional[str] = None
    num_cosines: int = 4096
    gamma: float = 0.0555
    distribution: str = "gaussian"
    block_size: int = 2048
    num_epochs: int = 3
    lam: float = 1e-3
    num_classes: int = 147
    n_synth: int = 4000
    synth_dim: int = 440
    seed: int = 0


def synthetic_timit(n: int, dim: int, num_classes: int, noise_seed: int,
                    class_seed: int = 1234,
                    device: DeviceLike = "cuda") -> LabeledData:
    """Class-dependent frames, a learnable stand-in: the classes come from
    ``class_seed``, so train and test share them; the noise and labels
    from ``noise_seed``. Made on the host with numpy exactly as the JAX
    package makes them (`_synthetic_timit`), then moved to ``device``."""
    crng = np.random.default_rng(class_seed)
    latent = crng.normal(size=(num_classes, 16)).astype(np.float32) * 3.0
    embed = crng.normal(size=(16, dim)).astype(np.float32) / 4.0
    rng = np.random.default_rng(noise_seed)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    X = latent[y] @ embed + 1.0 * rng.normal(size=(n, dim)).astype(np.float32)
    return LabeledData.from_arrays(y, X, device)


def load(config: TimitConfig, device) -> tuple:
    """(train, test, num_classes): the TIMIT files, or `synthetic_timit`."""
    if config.train_features:
        train = timit_loader(config.train_features, config.train_labels,
                             device)
        test = timit_loader(config.test_features or config.train_features,
                            config.test_labels or config.train_labels,
                            device)
        return train, test, config.num_classes
    num_classes = min(config.num_classes, SYNTH_MAX_CLASSES)
    return (synthetic_timit(config.n_synth, config.synth_dim, num_classes,
                            config.seed, device=device),
            synthetic_timit(config.n_synth // 4, config.synth_dim,
                            num_classes, config.seed + 1, device=device),
            num_classes)


def featurizer(dim: int, config: TimitConfig, device):
    """CosineRandomFeatures >> Cacher: the features are made once."""
    return CosineRandomFeatures(
        dim, config.num_cosines, config.gamma,
        distribution=config.distribution, seed=config.seed,
        device=device).to_pipeline() >> Cacher("timit-features")


def build(train: LabeledData, config: TimitConfig, num_classes: int):
    """featurizer >> BCD (fit lazily on ``train``) >> MaxClassifier."""
    labels = ClassLabelIndicatorsFromInt(num_classes)(train.labels).get()
    return featurizer(train.data.array.shape[1], config,
                      train.data.device).and_then(
        BlockLeastSquaresEstimator(config.block_size, config.num_epochs,
                                   config.lam),
        train.data, labels) >> MaxClassifier()


def run_on(train: LabeledData, test: LabeledData, config: TimitConfig,
           num_classes: int) -> dict:
    """Build the predictor, then score train and test. ``train_seconds``
    covers the train predict and evaluation, the lazy featurize and fit
    with them, closed by a device sync, as the JAX package's clock
    (`:112-116`)."""
    predictor = build(train, config, num_classes)
    evaluator = MulticlassClassifierEvaluator(num_classes)
    dev = train.data.device
    _sync(dev)
    t0 = time.perf_counter()
    train_eval = evaluator(predictor(train.data), train.labels)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    test_eval = evaluator(predictor(test.data), test.labels)
    return {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "test_accuracy": test_eval.accuracy,
        "train_seconds": elapsed,
        "frames_per_sec": train.data.count / elapsed,
        "summary": test_eval.summary(),
        "predictor": predictor,
    }


def analyzable(config: Optional[TimitConfig] = None,
               device: DeviceLike = "cuda"):
    """The predictor graph over abstract placeholder data, for static
    validation (`keystone_tpu/pipelines/timit.py:55-81`); the cosine
    weights live on ``device``. Returns ``(pipeline, source_spec)``."""
    from ..analysis import SpecDataset

    config = config or TimitConfig()
    dim, n = config.synth_dim, 256
    num_classes = min(config.num_classes, 12)
    feats = (CosineRandomFeatures(
        dim, config.num_cosines, config.gamma,
        distribution=config.distribution, seed=config.seed,
        device=device).to_pipeline()
        >> Cacher("timit-features"))
    data = SpecDataset((dim,), np.float32, count=n, name="timit-data")
    raw_labels = SpecDataset((), np.int32, count=n, name="timit-labels")
    labels = ClassLabelIndicatorsFromInt(num_classes)(raw_labels)
    predictor = feats.and_then(
        BlockLeastSquaresEstimator(
            min(config.block_size, config.num_cosines), config.num_epochs,
            config.lam),
        data, labels) >> MaxClassifier()
    return predictor, (dim,)


def run(config: TimitConfig, device: DeviceLike = "cuda") -> dict:
    """Load or synthesize the data (`load`), fit and score on
    ``device``."""
    device = resolve_device(device)
    train, test, num_classes = load(config, device)
    return run_on(train, test, config, num_classes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train-features")
    p.add_argument("--train-labels")
    p.add_argument("--test-features")
    p.add_argument("--test-labels")
    p.add_argument("--num-cosines", type=int, default=4096)
    p.add_argument("--gamma", type=float, default=0.0555)
    p.add_argument("--distribution", default="gaussian",
                   choices=["gaussian", "cauchy"])
    p.add_argument("--block-size", type=int, default=2048)
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--lam", type=float, default=1e-3)
    p.add_argument("--n-synth", type=int, default=4000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = vars(p.parse_args(argv))
    device = args.pop("device")
    config = TimitConfig(**{k: v for k, v in args.items() if v is not None})
    result = run(config, device)
    print(result["summary"])
    print(f"train_error={result['train_error']:.4f} "
          f"test_error={result['test_error']:.4f} "
          f"train_time={result['train_seconds']:.2f}s")
    return result


if __name__ == "__main__":
    main()
