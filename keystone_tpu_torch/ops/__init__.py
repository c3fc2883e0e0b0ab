"""Kernels and their plain versions (counterpart of `keystone_tpu/ops`)."""

from .kernels import (
    conv_rectify_pool,
    conv_rectify_pool_reference,
    folded_conv_reference,
    hwio_to_cmajor,
    rectify_pool,
    rectify_pool_reference,
    rectify_pool_vectorize,
    rectify_pool_vectorize_reference,
    reset_launches,
)

__all__ = [
    "conv_rectify_pool", "conv_rectify_pool_reference",
    "folded_conv_reference", "hwio_to_cmajor", "rectify_pool",
    "rectify_pool_reference", "rectify_pool_vectorize",
    "rectify_pool_vectorize_reference", "reset_launches",
]
