"""Carry fitted parameters across from the JAX package.

The JAX package's RandomPatchCifar parameters, as numpy arrays, become
the port's objects: the learned filters (K, D), the ZCA whitener W
(D, D) and means μ (D,); the fitted scaler's mean and std; BCD's W and
b. `fitted_predictor` assembles them into the port's fitted prediction
pipeline, so both packages compute the same function from the same
weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .nodes.learning.block_ls import BlockLinearMapper
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
