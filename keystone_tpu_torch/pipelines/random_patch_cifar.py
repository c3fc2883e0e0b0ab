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
components one stage at a time.

`run_fused` (JAX `_fused_step` `:266-385`, `run_fused` `:390-437`) is
the whole training run as one stream of launches with no host sync
between its stages: filter learning as the staged path does it (the
same draws from ``config.seed``), then `fused_fit` — each microbatch's
fused kernel writes its rows of one preallocated feature matrix, the
moments, BCD on the scaled features folded back into a raw-feature
(W, b), and both confusion matrices from one-hot products — ending in
one packed transfer of the two 10×10 matrices to the host.

On a mesh (`parallel/`; JAX `:106-222, 266-440`) every function here
fits data-parallel, one process per card: the data are this rank's rows
of the same arrays (`load_data`), the filters are learned from the
global draws (`learn_filters_from_indices`), K1 runs on this rank's
rows, and the scaler's moments, BCD's Grams and the confusion matrices
are all-reduced over ``data``. `run` takes the current mesh, the global
one once `parallel.init_multihost` has joined a group (the launcher's
``--coordinator``).

On a ``(data, model)`` mesh (`parallel.global_data_mesh(model_shards)`;
JAX `:340-380`) the images are model-replicated, as JAX places 4-D
leaves, so every rank of a model group runs K1 on its data row's images;
the features that leave the featurizer are each rank's column tile
(`Dataset`), the scaler's moments are the tile's, and BCD gathers each
block over ``model`` (`nodes/learning/block_ls.py`). `fused_fit` keeps
the same layout: its scaled features go into BCD as this rank's tile
(`feature_sharding(mesh, d_pad)`).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import mask_rows
from ..evaluation import MulticlassClassifierEvaluator
from ..loaders.cifar_loader import cifar_loader, synthetic_cifar
from ..nodes.images.core import (
    Convolver,
    ImageVectorizer,
    PixelScaler,
    Pooler,
    SymmetricRectifier,
)
from ..evaluation.multiclass import MulticlassMetrics
from ..nodes.learning.block_ls import (
    BlockLeastSquaresEstimator,
    bcd_fit,
    raise_if_unfactored,
)
from ..nodes.learning.zca import ZCAWhitener, zca_from_covariance
from ..nodes.stats.scalers import StandardScaler, moments
from ..nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from ..nodes.util.fusion import FusedBatchTransformer
from ..ops.kernels import conv_rectify_pool, hwio_to_cmajor, pooled_grid
from ..parallel.collectives import all_reduce, broadcast
from ..parallel.mesh import (
    current_mesh,
    data_rank,
    feature_sharding,
    model_rank,
    n_model_shards,
)
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


def learn_filters_from_indices(images, img_idx, patch_idx, filter_idx,
                               patch: int, step: int, eps: float = 0.1):
    """Whitened random-patch filters from given draws
    (`random_patch_cifar.py:139-175`). ``images``: (N, H, W, C) raw
    pixels, or a `Dataset` of them placed on a mesh (JAX `:106-222`):
    each rank cuts the patches of the drawn images it holds, one
    all-reduce makes the drawn patch matrix on every rank, the ZCA
    ``eigh`` runs on the data axis's rank 0, and the filters, whitener
    and means are broadcast from it, so every rank holds the same bits.
    Returns (filters (K, P·P·C), ZCAWhitener)."""
    mesh = getattr(images, "mesh", None)
    if mesh is None:
        if hasattr(images, "array"):
            images = images.array
        flat = _drawn_patches(images, img_idx, patch_idx, patch, step)
        filters, whitener, mu = _whitened_filters(flat, filter_idx, eps)
        return filters, ZCAWhitener(whitener, mu)
    flat = _drawn_patches_on_mesh(images, img_idx, patch_idx, patch, step)
    if data_rank(mesh) == 0:
        parts = _whitened_filters(flat, filter_idx, eps)
    else:
        k, d = len(filter_idx), flat.shape[1]
        parts = (flat.new_empty((k, d)), flat.new_empty((d, d)),
                 flat.new_empty((d,)))
    filters, whitener, mu = broadcast(parts, mesh)
    return filters, ZCAWhitener(whitener, mu)


def _drawn_patches(images: torch.Tensor, img_idx, patch_idx, patch: int,
                   step: int) -> torch.Tensor:
    """The drawn patches, (m, P·P·C) in [0, 1]: the drawn images' patches
    in draw order, then the drawn rows of them."""
    dev = images.device
    sel = images[_to_device(img_idx, dev)] / 255.0
    c = sel.shape[-1]
    flat = extract_patches_device(sel, patch, step).reshape(
        -1, patch * patch * c)
    return flat[_to_device(patch_idx, dev)]


def _drawn_patches_on_mesh(images, img_idx, patch_idx, patch: int,
                           step: int) -> torch.Tensor:
    """`_drawn_patches` of a mesh `Dataset`: this rank's drawn images cut
    into patches, its drawn rows written into a zero (m, P·P·C) matrix,
    and one all-reduce. Each drawn patch comes from one rank, so the sum
    is exact."""
    rows, lo = images.array, images._first_row
    dev = rows.device
    img_idx = img_idx.to(torch.int64)
    patch_idx = patch_idx.to(torch.int64)
    owned = (img_idx >= lo) & (img_idx < lo + rows.shape[0])
    # position of each owned draw among this rank's drawn images
    pos = torch.cumsum(owned.to(torch.int64), 0) - 1
    h, w, c = rows.shape[1:]
    grid = ((h - patch) // step + 1) * ((w - patch) // step + 1)
    mine = owned[patch_idx // grid]
    out = torch.zeros((patch_idx.shape[0], patch * patch * c),
                      dtype=torch.float32, device=dev)
    if bool(owned.any()):
        local = _drawn_patches(
            rows, img_idx[owned] - lo,
            (pos[patch_idx // grid] * grid + patch_idx % grid)[mine],
            patch, step)
        out[_to_device(torch.nonzero(mine).reshape(-1), dev)] = local
    return all_reduce(out, images.mesh)


def _whitened_filters(flat: torch.Tensor, filter_idx, eps: float):
    """(filters, whitener, means) from the drawn patches."""
    dev = flat.device
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
    return whitened[_to_device(filter_idx, dev)], whitener, mu


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on ``device``; to the card from pinned memory without
    waiting, so the copy is not a host sync."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def item_shape(train_data) -> tuple:
    """(H, W, C) of a training set's images: a device `Dataset`, or a
    source in host memory (`SpilledDataset`, `OutOfCoreDataset`)."""
    if hasattr(train_data, "item_shape"):
        return tuple(train_data.item_shape)
    return tuple(train_data.array.shape[1:])


def learn_filters(train_data, config):
    """Whitened random-patch filter learning (reference :45-57), with
    the draws seeded by ``config.seed``. From a source in host memory
    only the sampled images reach the card (each shard drawn once)."""
    n = train_data.count
    h, w = item_shape(train_data)[:2]
    n_sample, total, m = filter_sample_sizes(n, h, w, config)
    gen = torch.Generator().manual_seed(config.seed)
    img_idx, patch_idx, filter_idx = draw_filter_indices(
        n, n_sample, total, m, config.num_filters, gen)
    if getattr(train_data, "is_out_of_core", False):
        images = torch.from_numpy(train_data.gather(img_idx.numpy())).to(
            train_data.device)
        img_idx = torch.arange(n_sample)
    elif getattr(train_data, "mesh", None) is not None:
        images = train_data
    else:
        images = train_data.array
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


def analyzable(config: Optional[RandomPatchCifarConfig] = None,
               device="cuda"):
    """The prediction path over abstract placeholder data, for static
    validation (`keystone_tpu/pipelines/random_patch_cifar.py:46-81`):
    random filters stand in for the learned ones, whose shapes are the
    same, and live on ``device``; no data loads and no fit runs. Returns
    ``(pipeline, source_spec)``."""
    from ..analysis import SpecDataset

    config = config or RandomPatchCifarConfig(num_filters=32)
    h = w = 32
    c = 3
    n = 256
    rng = np.random.default_rng(config.seed)
    d = config.patch_size * config.patch_size * c
    filters = rng.normal(size=(config.num_filters, d)).astype(np.float32)
    feats = (
        PixelScaler().to_pipeline()
        >> Convolver(filters, h, w, c, whitener=None, device=device)
        >> SymmetricRectifier(alpha=config.alpha)
        >> Pooler(config.pool_stride, config.pool_size, pool_fn="sum")
        >> ImageVectorizer()
        >> Cacher("features")
    )
    data = SpecDataset((h, w, c), np.float32, count=n, name="cifar-images")
    raw_labels = SpecDataset((), np.int32, count=n, name="cifar-labels")
    labels = ClassLabelIndicatorsFromInt(config.num_classes)(raw_labels)
    predictor = (
        feats.and_then(StandardScaler(), data)
        .and_then(BlockLeastSquaresEstimator(config.block_size, 1,
                                             config.lam), data, labels)
        >> MaxClassifier()
    )
    return predictor, (h, w, c)


def build_pipeline(train, config, learned=None):
    """The full prediction pipeline, to fit. ``train.data`` is a device
    `Dataset` or a source in host memory (an `OutOfCoreDataset`, which
    the featurizer takes in windows); ``learned``, ``(filters,
    whitener)``, skips filter learning."""
    filters, whitener = (learned if learned is not None
                         else learn_filters(train.data, config))
    h, w, c = item_shape(train.data)
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


class StageClock:
    """CUDA events recorded on the stream at stage boundaries and read
    after the run's one sync: each stage's milliseconds on the stream,
    with no sync between stages. Off the card it records nothing."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.marks = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.on:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((name, event))

    def stage_ms(self) -> dict:
        """{stage: ms} between consecutive marks; call after a sync."""
        return {name: a.elapsed_time(b)
                for (_, a), (name, b) in zip(self.marks, self.marks[1:])}


def _one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) float32 indicators by comparison (no bounds check, no
    sync)."""
    classes = torch.arange(k, device=labels.device)
    return (labels.long()[:, None] == classes).to(torch.float32)


def fused_fit(train, test, filters, whitener, config, clock=None):
    """The training run after filter learning, as JAX's `_fused_step`
    does it (`random_patch_cifar.py:318-385`), as one stream of launches
    with no host sync: featurize the training images (each microbatch's
    fused conv+rectify+pool launch writes its rows of one (n, d)
    matrix), the scaler's moments, the pipeline's BCD on the scaled
    features folded back into a raw-feature (W, b), then the training
    and the test confusion matrices from one-hot products. Returns
    device tensors (W, b, conf_train, conf_test, info), ``info`` from
    `bcd_fit`. ``clock``, a `StageClock`, is marked after each stage."""
    clock = clock or StageClock(train.data.device)
    mesh, count = train.data.mesh, train.data.count
    # this rank's rows on a mesh (padded ones masked), else the count
    images = train.data.array[:count if mesh is None else None]
    mask = train.data.mask if train.data.has_padding else None
    n, h, w, c = images.shape
    conv = Convolver(filters, h, w, c, whitener=whitener,
                     normalize_patches=True)
    g_cmajor = hwio_to_cmajor(conv.kernel).contiguous()
    colsum, bias = conv.colsum.contiguous(), conv.bias.contiguous()
    gy, gx = pooled_grid(h - conv.patch + 1, w - conv.patch + 1,
                         config.pool_size, config.pool_stride)
    k = config.num_classes

    def featurize(imgs):
        x = torch.empty((imgs.shape[0], gy * gx * 2 * conv.num_filters),
                        dtype=torch.float32, device=imgs.device)
        for start in range(0, imgs.shape[0], config.microbatch):
            stop = start + config.microbatch
            conv_rectify_pool(
                imgs[start:stop].to(torch.float32) / 255.0, g_cmajor, colsum,
                bias, config.alpha, 0.0, config.pool_size,
                config.pool_stride, True, conv.patch, out=x[start:stop])
        return x

    def confusion(x, labels, W, b, mask):
        pred = torch.argmax(x @ W + b, dim=1)
        truth = _one_hot(labels, k)
        if mask is not None:
            truth = mask_rows(truth, mask)
        cm = truth.T @ _one_hot(pred, k)
        return cm if mesh is None else all_reduce(cm, mesh)

    X = featurize(images)
    clock.mark("featurize")
    mu, sd = moments(X, count, True, mask, mesh)
    clock.mark("scaler")
    labels = train.labels.array[:n]
    Y = 2.0 * _one_hot(labels, k) - 1.0
    d = X.shape[1]
    B = min(config.block_size, d)
    Xs = F.pad((X - mu) / sd, (0, -d % B))
    tile = {}
    if mesh is not None and feature_sharding(mesh, Xs.shape[1]) is not None:
        # JAX's x_sharding: BCD takes this rank's column tile
        w = Xs.shape[1] // n_model_shards(mesh)
        lo = model_rank(mesh) * w
        tile = dict(model_mesh=mesh, col_start=lo, width=Xs.shape[1])
        Xs = Xs[:, lo:lo + w].contiguous()
    Ws, bs, info = bcd_fit(Xs, Y, config.lam, B, config.bcd_iters,
                           mask=mask, mesh=mesh, count=count, **tile)
    Ws = Ws[:d]
    # fold the scaling back: x·W + b on raw features
    W = Ws / sd[:, None]
    b = bs - (mu / sd) @ Ws
    del Xs
    clock.mark("bcd_solve")
    conf_train = confusion(X, labels, W, b, mask)
    clock.mark("train_eval")
    del X
    Xt = featurize(test.data.array[:test.data.count if mesh is None
                                   else None])
    conf_test = confusion(Xt, test.labels.array[:Xt.shape[0]], W, b,
                          test.data.mask if test.data.has_padding else None)
    clock.mark("test_featurize_eval")
    return W, b, conf_train, conf_test, info


def run_fused(train, test, config):
    """One stream of launches for the whole training run (`fused_fit`
    after `learn_filters`, the staged path's filters), ended by one
    transfer of both confusion matrices and BCD's check. Returns the
    raw-feature model (W, b) on the device, the metrics, and
    ``stage_ms``, each stage's milliseconds on the stream (on the card;
    empty on the CPU)."""
    clock = StageClock(train.data.device)
    filters, whitener = learn_filters(train.data, config)
    clock.mark("filter_learning")
    W, b, conf_train, conf_test, info = fused_fit(
        train, test, filters, whitener, config, clock)
    k = config.num_classes
    packed = torch.cat([conf_train.flatten(), conf_test.flatten(),
                        info.to(torch.float32)[None]]).cpu().numpy()
    raise_if_unfactored(torch.tensor(int(packed[-1])))
    train_m = MulticlassMetrics(packed[:k * k].reshape(k, k)
                                .astype(np.float64))
    test_m = MulticlassMetrics(packed[k * k:2 * k * k].reshape(k, k)
                               .astype(np.float64))
    return {
        "W": W, "b": b,
        "train_metrics": train_m, "test_metrics": test_m,
        "train_error": train_m.error, "test_accuracy": test_m.accuracy,
        "stage_ms": clock.stage_ms(),
    }


def load_data(config, device, mesh=None):
    """(train, test): CIFAR from ``config.train_path``/``test_path``, or
    ``synthetic_cifar`` at ``config.synth_train``/``synth_test``; with
    ``mesh``, this rank's rows."""
    if config.train_path:
        return (cifar_loader(config.train_path, device=device, mesh=mesh),
                cifar_loader(config.test_path or config.train_path,
                             device=device, mesh=mesh))
    return synthetic_cifar(config.synth_train, config.synth_test,
                           config.num_classes, config.seed, device=device,
                           mesh=mesh)


def fit_and_score(build, train, test, num_classes: int):
    """Fit with ``build()`` and score train and test; the train clock
    covers the fit and the train predict and evaluation, closed by a
    device sync."""
    dev = train.data.device
    _sync(dev)
    t0 = time.perf_counter()
    predictor = build()
    evaluator = MulticlassClassifierEvaluator(num_classes)
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
        "test_confusion": test_metrics.confusion,
        "predictor": predictor,
    }


def run(config: RandomPatchCifarConfig, device="cuda", fused: bool = False,
        mesh=None):
    """Load or synthesize the data, fit, and score train and test; with
    ``fused``, through `run_fused`, whose clock also covers the test
    featurize and evaluation, so its rate counts train + test images (as
    the JAX package reports it, `random_patch_cifar.py:501-531`). On
    ``mesh`` (default the current one: none in one process), data-parallel
    over its ranks."""
    train, test = load_data(config, device,
                            mesh if mesh is not None else current_mesh())
    if not fused:
        return fit_and_score(lambda: build_pipeline(train, config), train,
                             test, config.num_classes)
    _sync(train.data.device)
    t0 = time.perf_counter()
    res = run_fused(train, test, config)
    t_total = time.perf_counter() - t0
    test_metrics = res["test_metrics"]
    return {
        "train_error": res["train_error"],
        "test_error": test_metrics.error,
        "test_accuracy": test_metrics.accuracy,
        "train_seconds": t_total,
        "images_per_sec": (train.data.count + test.data.count) / t_total,
        "rate_basis": "train+test images (the fused run includes the test "
                      "featurize and evaluation)",
        "summary": test_metrics.summary(),
        "model": (res["W"], res["b"]),
        "stage_ms": res["stage_ms"],
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
    p.add_argument("--fused", action="store_true",
                   help="run the whole fit as one stream of launches with "
                        "no host sync between stages (run_fused)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    device, fused = args.device, args.fused
    del args.device, args.fused
    config = RandomPatchCifarConfig(
        **{k: v for k, v in vars(args).items() if v is not None})
    result = run(config, device=device, fused=fused)
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
