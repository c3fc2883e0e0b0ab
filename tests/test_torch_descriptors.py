"""Dense SIFT, LCS and the separable convolution: the port against the
JAX package on the CPU.

SIFT ends in min(floor(512·v), 255), so a last-bit difference in v moves
an entry by exactly 1 where 512·v lies next to an integer. The
descriptors are held as integers: the same shape and frame order, every
entry equal or off by exactly 1, and the entries off by 1 at most
``SIFT_OFF_BY_ONE_SHARE`` of all. Measured, port CPU against JAX CPU:
1.2e-4 on the whole 264×400 gantrycrane.png at step 6 and 2 scales,
1.0e-4 at the defaults, 8.9e-5 at 5 scales; 2.8e-5 and 0 on random
48×48 images. LCS and the convolution are held to float32 rounding.
"""

import os

import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images.descriptors import LCSExtractor as JaxLCS
from keystone_tpu.nodes.images.sift import SIFTExtractor as JaxSIFT
from keystone_tpu.utils.images import depthwise_conv2d as jax_conv
from keystone_tpu_torch.data.dataset import HostDataset
from keystone_tpu_torch.nodes.images.descriptors import LCSExtractor
from keystone_tpu_torch.nodes.images.sift import SIFTExtractor, sift_batch
from keystone_tpu_torch.utils.images import depthwise_conv2d

RESOURCE = os.path.join(os.path.dirname(__file__), "resources",
                        "gantrycrane.png")
#: share of SIFT entries allowed to differ (each by exactly 1)
SIFT_OFF_BY_ONE_SHARE = 1e-3
#: LCS means and stds of [0, 1] pixels; the std's cancellation
#: (E[x²] − E[x]², clamped at 0) is where float32 rounding shows most
LCS_ATOL = 2e-6
CONV_RTOL = 1e-6


@pytest.fixture(scope="module")
def gantry_gray():
    from PIL import Image

    img = np.asarray(Image.open(RESOURCE), dtype=np.float32) / 255.0
    return img[..., :3] @ np.asarray([0.299, 0.587, 0.114], np.float32)


def _synthetic(n=6, side=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, size=(n, side, side)).astype(np.float32)


def _assert_sift_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, np.floor(got))
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= SIFT_OFF_BY_ONE_SHARE


SIFT_PARAMS = [dict(step=6, num_scales=2), dict(), dict(num_scales=5)]
SIFT_IDS = ["step6_2scales", "defaults", "5scales"]


@pytest.mark.parametrize("params", SIFT_PARAMS, ids=SIFT_IDS)
def test_sift_matches_jax_on_gantrycrane(gantry_gray, params):
    want = np.asarray(JaxSIFT(**params).apply(gantry_gray))
    got = SIFTExtractor(**params).apply(gantry_gray)
    _assert_sift_close(got, want)


@pytest.mark.parametrize("params", SIFT_PARAMS[:2], ids=SIFT_IDS[:2])
def test_sift_matches_jax_on_synthetic_batch(params):
    imgs = _synthetic()
    want = np.stack([np.asarray(JaxSIFT(**params).apply(x)) for x in imgs])
    got = sift_batch(torch.from_numpy(imgs)[..., None], **params)
    _assert_sift_close(got, want)


def test_sift_five_scales_clamps_the_offset():
    """From 5 scales the raw frame offset (1 + 2·S) − 3s goes negative at
    the last scale; clamped at 0 the frames start at the image's corner
    rather than wrapping to the far edge."""
    imgs = _synthetic(2, 40, seed=3)
    got = sift_batch(torch.from_numpy(imgs), num_scales=5).numpy()
    want = np.stack([np.asarray(JaxSIFT(num_scales=5).apply(x))
                     for x in imgs])
    _assert_sift_close(got, want)
    # the last scale alone, started at offset 0, gives its descriptors
    from keystone_tpu_torch.nodes.images.sift import (
        _sift_one_scale,
        scale_constants,
    )

    last = _sift_one_scale(torch.from_numpy(imgs), 4 + 2 * 4, 3 + 4, 0,
                           scale_constants(4 + 2 * 4, "cpu"))
    np.testing.assert_array_equal(got[:, -last.shape[1]:], last.numpy())


def test_sift_over_a_host_dataset_buckets_by_shape():
    rng = np.random.default_rng(4)
    imgs = [rng.uniform(0, 1, size=s).astype(np.float32)
            for s in [(48, 48, 1), (40, 52, 1), (48, 48, 1), (40, 52, 1)]]
    out = SIFTExtractor(step=6, num_scales=2).apply_batch(
        HostDataset(imgs, device="cpu"))
    assert len(out.buckets()) == 2
    for got, img in zip(out.items, imgs):
        _assert_sift_close(got, JaxSIFT(step=6, num_scales=2).apply(img))


@pytest.mark.parametrize("params", [dict(stride=6), dict(),
                                    dict(stride=5, subpatch_size=4,
                                         subpatches=3)],
                         ids=["stride6", "defaults", "odd_box"])
def test_lcs_matches_jax(params):
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 1, size=(3, 48, 53, 3)).astype(np.float32)
    want = np.stack([np.asarray(JaxLCS(**params).apply(x)) for x in imgs])
    got = LCSExtractor(**params).apply_batch(
        HostDataset(list(imgs), device="cpu"))
    got = np.stack([np.asarray(x) for x in got.items])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LCS_ATOL)


@pytest.mark.parametrize("taps", [(6, 5), (3, 4), (1, 7)],
                         ids=["even_odd", "odd_even", "one_seven"])
@pytest.mark.parametrize("padding", ["same", "edge"])
def test_depthwise_conv2d_matches_jax(taps, padding):
    """On an asymmetric image, so a wrong split of an even kernel's
    padding (XLA's SAME: the extra zero after) shows."""
    rng = np.random.default_rng(6)
    img = rng.normal(size=(11, 14, 3)).astype(np.float32)
    img[:, :3] += 5.0
    ky = rng.normal(size=taps[0]).astype(np.float32)
    kx = rng.normal(size=taps[1]).astype(np.float32)
    want = np.asarray(jax_conv(img, ky, kx, padding))
    got = depthwise_conv2d(torch.from_numpy(img), ky, kx, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=CONV_RTOL,
                               atol=CONV_RTOL * np.abs(want).max())
    batch = depthwise_conv2d(torch.from_numpy(np.stack([img, -img])), ky, kx,
                             padding).numpy()
    np.testing.assert_array_equal(batch[0], got)
    np.testing.assert_allclose(batch[1], -got, rtol=0, atol=1e-6)
