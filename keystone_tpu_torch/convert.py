"""Carry fitted parameters across from the JAX package.

The JAX package's fitted parameters, as numpy arrays, become the port's
objects: the learned filters (K, D), the ZCA whitener W (D, D) and means
μ (D,); the fitted scaler's mean and std; BCD's W and b; a
`LinearMapper`'s W and b; a `KernelBlockLinearMapper`'s anchors, dual
weights, γ and block size. `fitted_predictor`,
`fitted_linear_pixels`, `fitted_kernel_predictor` and
`fitted_augmented_scorer` (RandomPatchCifarAugmented and its kernel
variant, whose scores are averaged over test views before the argmax)
assemble them into the port's fitted pipelines, so both packages compute
the same function from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .nodes.learning.block_ls import BlockLinearMapper
from .nodes.learning.kernels import KernelBlockLinearMapper
from .nodes.learning.linear import LinearMapper
from .nodes.learning.zca import ZCAWhitener
from .nodes.stats.scalers import StandardScalerModel
from .nodes.util.basic import MaxClassifier
from .workflow.pipeline import Pipeline


def to_tensor(x, device: DeviceLike = "cuda") -> torch.Tensor:
    """A float32 tensor on ``device`` from an array."""
    return torch.tensor(np.asarray(x, np.float32),
                        device=resolve_device(device))


def whitener(W, mu, device: DeviceLike = "cuda") -> ZCAWhitener:
    return ZCAWhitener(to_tensor(W, device), to_tensor(mu, device))


def fitted_predictor(filters, whitener_W, whitener_mu, scaler_mean,
                     scaler_std, bcd_W, bcd_b, image_shape, config,
                     device: DeviceLike = "cuda") -> Pipeline:
    """featurizer >> StandardScalerModel >> BlockLinearMapper >>
    MaxClassifier, from the JAX package's fitted RandomPatchCifar
    parameters. ``image_shape`` is (H, W, C)."""
    from .pipelines.random_patch_cifar import make_featurizer

    h, w, c = image_shape
    featurizer = make_featurizer(
        to_tensor(filters, device), whitener(whitener_W, whitener_mu, device),
        h, w, c, config)
    return (featurizer.to_pipeline()
            >> StandardScalerModel(to_tensor(scaler_mean, device),
                                   to_tensor(scaler_std, device))
            >> BlockLinearMapper(to_tensor(bcd_W, device),
                                 to_tensor(bcd_b, device))
            >> MaxClassifier())


def block_linear_mapper(W, b,
                        device: DeviceLike = "cuda") -> BlockLinearMapper:
    return BlockLinearMapper(to_tensor(W, device), to_tensor(b, device))


def linear_mapper(W, b=None, device: DeviceLike = "cuda") -> LinearMapper:
    return LinearMapper(to_tensor(W, device),
                        None if b is None else to_tensor(b, device))


def kernel_mapper(train_X, alpha, gamma: float, block_size: int,
                  device: DeviceLike = "cuda") -> KernelBlockLinearMapper:
    return KernelBlockLinearMapper(to_tensor(train_X, device),
                                   to_tensor(alpha, device), float(gamma),
                                   int(block_size))


def fitted_linear_pixels(W, b, device: DeviceLike = "cuda") -> Pipeline:
    """LinearPixels' featurizer >> LinearMapper >> MaxClassifier from the
    JAX package's fitted `LinearMapper`."""
    from .pipelines.cifar_variants import linear_pixels_featurizer

    return (linear_pixels_featurizer().to_pipeline()
            >> linear_mapper(W, b, device) >> MaxClassifier())


def fitted_kernel_predictor(filters, whitener_W, whitener_mu, scaler_mean,
                            scaler_std, train_X, alpha, gamma: float,
                            block_size: int, image_shape, config,
                            device: DeviceLike = "cuda") -> Pipeline:
    """featurizer >> StandardScalerModel >> KernelBlockLinearMapper >>
    MaxClassifier, from the JAX package's fitted RandomPatchCifarKernel
    parameters. ``image_shape`` is (H, W, C)."""
    from .pipelines.random_patch_cifar import make_featurizer

    h, w, c = image_shape
    featurizer = make_featurizer(
        to_tensor(filters, device), whitener(whitener_W, whitener_mu, device),
        h, w, c, config)
    return (featurizer.to_pipeline()
            >> StandardScalerModel(to_tensor(scaler_mean, device),
                                   to_tensor(scaler_std, device))
            >> kernel_mapper(train_X, alpha, gamma, block_size, device)
            >> MaxClassifier())


def fitted_augmented_scorer(filters, whitener_W, whitener_mu, scaler_mean,
                            scaler_std, model, config,
                            device: DeviceLike = "cuda") -> Pipeline:
    """The augmented pipelines' featurizer over ``config.aug_patch``
    crops >> StandardScalerModel >> ``model`` (from `block_linear_mapper`
    or `kernel_mapper`), from the JAX package's fitted parameters; no
    argmax, as the test views' scores are averaged first."""
    from .pipelines.cifar_variants import augmented_featurizer

    featurizer = augmented_featurizer(
        to_tensor(filters, device), whitener(whitener_W, whitener_mu, device),
        config)
    return (featurizer.to_pipeline()
            >> StandardScalerModel(to_tensor(scaler_mean, device),
                                   to_tensor(scaler_std, device))
            >> model)
