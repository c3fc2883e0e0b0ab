"""CIFAR variants on one CUDA card: LinearPixels and
RandomPatchCifarKernel.

Counterpart of `keystone_tpu/pipelines/cifar_variants.py`:

- LinearPixels (`:57-113`; reference LinearPixels.scala):
  PixelScaler → GrayScaler → ImageVectorizer as one
  `FusedBatchTransformer` over 4096-row microbatches, whose three stages
  run as one elementwise chain kernel launch, then a `Cacher`,
  `LinearMapEstimator(λ)` and `MaxClassifier`.
- RandomPatchCifarKernel (`:163-207`; RandomPatchCifarKernel.scala:62-75):
  RandomPatchCifar's learned filters and featurizer, then
  `StandardScaler` and `KernelRidgeRegression`, whose block steps and
  apply run the RBF block kernel.

`build_linear_pixels` and `build_random_patch_cifar_kernel` fit a
predictor on given training data; the ``run_*`` functions load or
synthesize the data, fit and score. RandomCifar and the augmented
variants are not ported yet.

    python -m keystone_tpu_torch.pipelines.cifar_variants linear-pixels
    python -m keystone_tpu_torch.pipelines.cifar_variants kernel --device cpu
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional

from ..nodes.images.core import GrayScaler, ImageVectorizer, PixelScaler
from ..nodes.learning.kernels import KernelRidgeRegression
from ..nodes.learning.linear import LinearMapEstimator
from ..nodes.stats.scalers import StandardScaler
from ..nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from ..nodes.util.fusion import FusedBatchTransformer
from .random_patch_cifar import (
    RandomPatchCifarConfig,
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


def run_linear_pixels(config: LinearPixelsConfig, device="cuda"):
    """Load or synthesize the data, fit LinearPixels, score train and
    test."""
    train, test = load_data(config, device)
    return fit_and_score(lambda: build_linear_pixels(train, config), train,
                         test, config.num_classes)


@dataclass
class RandomPatchCifarKernelConfig(RandomPatchCifarConfig):
    gamma: float = 2e-3
    kernel_block: int = 2048
    kernel_epochs: int = 1


def build_random_patch_cifar_kernel(train,
                                    config: RandomPatchCifarKernelConfig):
    """Build + fit the RandomPatchCifarKernel predictor on ``train``."""
    filters, whitener = learn_filters(train.data, config)
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
                                  device="cuda"):
    """Load or synthesize the data, fit RandomPatchCifarKernel, score
    train and test."""
    train, test = load_data(config, device)
    return fit_and_score(
        lambda: build_random_patch_cifar_kernel(train, config), train, test,
        config.num_classes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pipeline", choices=("linear-pixels", "kernel"))
    p.add_argument("--train-path", dest="train_path")
    p.add_argument("--test-path", dest="test_path")
    p.add_argument("--lam", type=float)
    p.add_argument("--num-filters", dest="num_filters", type=int,
                   help="kernel only")
    p.add_argument("--gamma", type=float, help="kernel only")
    p.add_argument("--kernel-block", dest="kernel_block", type=int,
                   help="kernel only")
    p.add_argument("--kernel-epochs", dest="kernel_epochs", type=int,
                   help="kernel only")
    p.add_argument("--synth-train", dest="synth_train", type=int)
    p.add_argument("--synth-test", dest="synth_test", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = vars(p.parse_args(argv))
    pipeline, device = args.pop("pipeline"), args.pop("device")
    given = {k: v for k, v in args.items() if v is not None}
    if pipeline == "linear-pixels":
        kernel_only = {"num_filters", "gamma", "kernel_block",
                       "kernel_epochs"} & set(given)
        if kernel_only:
            p.error(f"linear-pixels takes no {sorted(kernel_only)}")
        result = run_linear_pixels(LinearPixelsConfig(**given), device)
    else:
        result = run_random_patch_cifar_kernel(
            RandomPatchCifarKernelConfig(**given), device)
    print(result["summary"])
    print(f"train_error={result['train_error']:.4f} "
          f"test_error={result['test_error']:.4f} "
          f"train_time={result['train_seconds']:.2f}s "
          f"({result['images_per_sec']:.0f} img/s)")
    return result


if __name__ == "__main__":
    main()
