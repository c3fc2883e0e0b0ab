"""RandomPatchCifar on one CUDA card.

Counterpart of `keystone_tpu/pipelines/random_patch_cifar.py`
(reference pipelines/images/cifar/RandomPatchCifar.scala:21-86). Filters
are whitened random patches from the training set (Coates & Ng style):

  filter learning (:45-57):
    sample images → all 6×6 patches → sample patches → normalize rows
    → ZCA whitener → whiten → normalize → pick num_filters rows
  prediction pipeline (:59-69):
    Convolver(filters, whitener) → SymmetricRectifier(α=0.25)
    → Pooler(stride, size, sum) → ImageVectorizer → Cacher
    → StandardScaler → BlockLeastSquares(4096, 1, λ) → MaxClassifier

The featurizer is one `FusedBatchTransformer` whose conv, rectify and
pool run in the fused conv+rectify+pool CUDA kernel. Filter learning is
split in two: `draw_filter_indices` makes the random draws from a
`torch.Generator`, and `learn_filters_from_indices` does the rest, so
the arithmetic can be fed any draw. `run_staged` times the same
components one stage at a time. The one-program `run_fused` of the JAX
package is not ported yet.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..evaluation import MulticlassClassifierEvaluator
from ..loaders.cifar_loader import cifar_loader, synthetic_cifar
from ..nodes.images.core import (
    Convolver,
    ImageVectorizer,
    PixelScaler,
    Pooler,
    SymmetricRectifier,
)
from ..nodes.learning.block_ls import BlockLeastSquaresEstimator
from ..nodes.learning.zca import ZCAWhitener, zca_from_covariance
from ..nodes.stats.scalers import StandardScaler
from ..nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from ..nodes.util.fusion import FusedBatchTransformer
from ..utils.images import extract_patches_device


@dataclass
class RandomPatchCifarConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_filters: int = 256
    patch_size: int = 6
    patch_steps: int = 1
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: float = 10.0
    sample_patches: int = 100_000
    block_size: int = 4096
    bcd_iters: int = 1
    num_classes: int = 10
    microbatch: int = 2048
    seed: int = 0
    # synthetic data sizes (used when no train_path)
    synth_train: int = 2000
    synth_test: int = 500


def filter_sample_sizes(n: int, h: int, w: int, config):
    """(n_sample, total, m): images sampled, patches they hold, and
    patches kept for the whitener."""
    n_sample = min(n, max(config.sample_patches // 100, 64))
    gy = (h - config.patch_size) // config.patch_steps + 1
    gx = (w - config.patch_size) // config.patch_steps + 1
    total = n_sample * gy * gx
    return n_sample, total, min(total, config.sample_patches)


def draw_filter_indices(n: int, n_sample: int, total: int, m: int,
                        num_filters: int, generator: torch.Generator):
    """The three draws of filter learning: images and filters without
    replacement, patches with replacement (as the JAX package draws
    them, `random_patch_cifar.py:125-152`). CPU int64 tensors."""
    img_idx = torch.randperm(n, generator=generator)[:n_sample]
    patch_idx = torch.randint(0, total, (m,), generator=generator)
    filter_idx = torch.randperm(m, generator=generator)[:num_filters]
    return img_idx, patch_idx, filter_idx


def learn_filters_from_indices(images: torch.Tensor, img_idx, patch_idx,
                               filter_idx, patch: int, step: int,
                               eps: float = 0.1):
    """Whitened random-patch filters from given draws
    (`random_patch_cifar.py:139-175`). images: (N, H, W, C) raw pixels.
    Returns (filters (K, P·P·C), ZCAWhitener)."""
    dev = images.device
    sel = images[img_idx.to(dev)] / 255.0
    c = sel.shape[-1]
    flat = extract_patches_device(sel, patch, step).reshape(
        -1, patch * patch * c)
    flat = flat[patch_idx.to(dev)]
    # normalizeRows(_, 10.0): subtract the patch mean, divide by
    # max(norm, 10/255)
    flat = flat - flat.mean(dim=1, keepdim=True)
    norms = torch.linalg.norm(flat, dim=1, keepdim=True)
    flat = flat / torch.clamp(norms, min=10.0 / 255.0)
    m = flat.shape[0]
    mu = flat.sum(dim=0) / m
    cov = (flat.T @ flat - m * torch.outer(mu, mu)) / max(m - 1.0, 1.0)
    whitener = zca_from_covariance(cov, eps)
    whitened = (flat - mu) @ whitener
    wnorms = torch.linalg.norm(whitened, dim=1, keepdim=True)
    whitened = whitened / torch.clamp(wnorms, min=1e-8)
    filters = whitened[filter_idx.to(dev)]
    return filters, ZCAWhitener(whitener, mu)


def learn_filters(train_data, config):
    """Whitened random-patch filter learning (reference :45-57), with
    the draws seeded by ``config.seed``."""
    images = train_data.array
    n = train_data.count
    h, w = images.shape[1:3]
    n_sample, total, m = filter_sample_sizes(n, h, w, config)
    gen = torch.Generator().manual_seed(config.seed)
    img_idx, patch_idx, filter_idx = draw_filter_indices(
        n, n_sample, total, m, config.num_filters, gen)
    return learn_filters_from_indices(
        images, img_idx, patch_idx, filter_idx, config.patch_size,
        config.patch_steps)


def make_featurizer(filters, whitener, h, w, c, config,
                    microbatch: Optional[int] = None) -> FusedBatchTransformer:
    """The featurization stack (scale → folded-whitening conv →
    two-sided ReLU → sum-pool → flatten) over microbatches."""
    return FusedBatchTransformer(
        [
            PixelScaler(),
            Convolver(filters, h, w, c, whitener=whitener,
                      normalize_patches=True),
            SymmetricRectifier(alpha=config.alpha),
            Pooler(config.pool_stride, config.pool_size, pool_fn="sum"),
            ImageVectorizer(),
        ],
        microbatch=microbatch if microbatch is not None else config.microbatch,
    )


def build_pipeline(train, config):
    """Build + fit the full prediction pipeline."""
    filters, whitener = learn_filters(train.data, config)
    h, w, c = train.data.array.shape[1:]
    featurizer = (
        make_featurizer(filters, whitener, h, w, c, config).to_pipeline()
        >> Cacher("features")
    )
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(
        train.labels).get()
    return (
        featurizer
        .and_then(StandardScaler(), train.data)
        .and_then(
            BlockLeastSquaresEstimator(config.block_size,
                                       num_iter=config.bcd_iters,
                                       lam=config.lam),
            train.data, labels,
        )
        >> MaxClassifier()
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_staged(train, config, evaluator):
    """The components `build_pipeline` assembles, run one stage at a
    time with a device sync closing each stage, so the per-stage wall
    clocks sum to the staged total. Returns (stage_seconds,
    train_metrics). Stages follow the reference app's phases
    (RandomPatchCifar.scala:21-86)."""
    dev = train.data.device
    stages = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        stages[name] = time.perf_counter() - t0
        return out

    filters, whitener = timed(
        "filter_learning", lambda: learn_filters(train.data, config))
    h, w, c = train.data.array.shape[1:]
    feats = timed("featurize", lambda: make_featurizer(
        filters, whitener, h, w, c, config).apply_batch(train.data))
    scaled = timed("scaler", lambda: StandardScaler().fit(feats)
                   .apply_batch(feats))

    def solve():
        labels = ClassLabelIndicatorsFromInt(config.num_classes).apply_batch(
            train.labels)
        return BlockLeastSquaresEstimator(
            config.block_size, num_iter=config.bcd_iters, lam=config.lam
        ).fit(scaled, labels)

    model = timed("bcd_solve", solve)
    train_metrics = timed("predict_eval", lambda: evaluator(
        MaxClassifier().apply_batch(model.apply_batch(scaled)),
        train.labels))
    return stages, train_metrics


def run(config: RandomPatchCifarConfig, device="cuda"):
    """Load or synthesize the data, fit, and score train and test."""
    if config.train_path:
        train = cifar_loader(config.train_path, device=device)
        test = cifar_loader(config.test_path or config.train_path,
                            device=device)
    else:
        train, test = synthetic_cifar(
            config.synth_train, config.synth_test, config.num_classes,
            config.seed, device=device)
    dev = train.data.device
    _sync(dev)
    t0 = time.perf_counter()
    predictor = build_pipeline(train, config)
    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    train_metrics = evaluator(predictor(train.data), train.labels)
    _sync(dev)
    t_train = time.perf_counter() - t0
    test_metrics = evaluator(predictor(test.data), test.labels)
    return {
        "train_error": train_metrics.error,
        "test_error": test_metrics.error,
        "test_accuracy": test_metrics.accuracy,
        "train_seconds": t_train,
        "images_per_sec": train.data.count / t_train,
        "summary": test_metrics.summary(),
        "predictor": predictor,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train-path", dest="train_path")
    p.add_argument("--test-path", dest="test_path")
    p.add_argument("--num-filters", dest="num_filters", type=int, default=256)
    p.add_argument("--patch-size", dest="patch_size", type=int, default=6)
    p.add_argument("--pool-size", dest="pool_size", type=int, default=14)
    p.add_argument("--pool-stride", dest="pool_stride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--lam", type=float, default=10.0)
    p.add_argument("--block-size", dest="block_size", type=int, default=4096)
    p.add_argument("--synth-train", dest="synth_train", type=int,
                   default=2000)
    p.add_argument("--synth-test", dest="synth_test", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    device = args.device
    del args.device
    config = RandomPatchCifarConfig(
        **{k: v for k, v in vars(args).items() if v is not None})
    result = run(config, device=device)
    print(result["summary"])
    print(
        f"train_error={result['train_error']:.4f} "
        f"test_error={result['test_error']:.4f} "
        f"train_time={result['train_seconds']:.2f}s "
        f"({result['images_per_sec']:.0f} img/s)"
    )
    return result


if __name__ == "__main__":
    main()
