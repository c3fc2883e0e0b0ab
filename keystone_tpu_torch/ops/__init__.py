"""Kernels and their plain versions (counterpart of `keystone_tpu/ops`)."""

from .chain_kernels import (
    build_chain_fn,
    elementwise_chain,
    elementwise_chain_reference,
    lowerability,
)
from .kernels import (
    conv_rectify_pool,
    conv_rectify_pool_reference,
    folded_conv_reference,
    hwio_to_cmajor,
    rbf_block,
    rbf_block_reference,
    rectify_pool,
    rectify_pool_reference,
    rectify_pool_vectorize,
    rectify_pool_vectorize_reference,
    reset_launches,
)

__all__ = [
    "build_chain_fn", "conv_rectify_pool", "conv_rectify_pool_reference",
    "elementwise_chain", "elementwise_chain_reference",
    "folded_conv_reference", "hwio_to_cmajor", "lowerability", "rbf_block",
    "rbf_block_reference", "rectify_pool", "rectify_pool_reference",
    "rectify_pool_vectorize", "rectify_pool_vectorize_reference",
    "reset_launches",
]
