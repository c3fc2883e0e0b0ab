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
the same function from the same weights. For the SIFT–Fisher family: a
fitted PCA's components (d, k), a GMM's means and variances (k, d) and
weights (k,), and the class-weighted solver's W and b, assembled by
`fitted_voc_predictor` and `fitted_imagenet_predictor`. For the text
family: a vocabulary (feature → column), naive Bayes' log priors (k,)
and log conditionals (k, d), and logistic regression's W (d, k),
assembled by `fitted_text_predictor` and `fitted_newsgroups_predictor`.
For the taggers: a CRF's tags and weights (`crf_tagger_from_jax`) and a
perceptron's weight dicts (`perceptron_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .nodes.images.fisher_vector import FisherVector
from .nodes.learning.block_ls import BlockLinearMapper
from .nodes.learning.classifiers import (
    LogisticRegressionModel,
    NaiveBayesModel,
)
from .nodes.learning.gmm import GaussianMixtureModel
from .nodes.learning.kernels import KernelBlockLinearMapper
from .nodes.learning.linear import LinearMapper
from .nodes.learning.pca import PCATransformer
from .nodes.learning.zca import ZCAWhitener
from .nodes.stats.scalers import StandardScalerModel
from .nodes.stats.normalization import NormalizeRows, SignedHellingerMapper
from .nodes.util.basic import MatrixVectorizer, MaxClassifier
from .nodes.util.sparse_features import SparseFeatureVectorizer
from .workflow.pipeline import Pipeline, Transformer


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


def pca_transformer(components, device: DeviceLike = "cuda") -> PCATransformer:
    return PCATransformer(to_tensor(components, device))


def gmm(means, variances, weights,
        device: DeviceLike = "cuda") -> GaussianMixtureModel:
    return GaussianMixtureModel(to_tensor(means, device),
                                to_tensor(variances, device),
                                to_tensor(weights, device))


def _fisher_encoder(pca, mixture, device) -> Pipeline:
    """descriptors >> PCA >> FisherVector >> the per-image
    normalizations, from (components) and (means, variances, weights)."""
    return (pca_transformer(pca, device).to_pipeline()
            >> FisherVector(gmm(*mixture, device=device))
            >> MatrixVectorizer() >> SignedHellingerMapper()
            >> NormalizeRows())


def fitted_voc_predictor(pca_components, gmm_means, gmm_variances,
                         gmm_weights, W, b,
                         device: DeviceLike = "cuda") -> Pipeline:
    """VOCSIFTFisher's images → scores from the JAX package's fitted
    PCA, GMM and class-weighted solver."""
    from .nodes.images.core import GrayScaler, PixelScaler
    from .nodes.images.extractors import MultiLabeledImageExtractor
    from .nodes.images.sift import SIFTExtractor
    from .pipelines.voc_sift_fisher import _Stack

    return (MultiLabeledImageExtractor().to_pipeline() >> PixelScaler()
            >> GrayScaler() >> SIFTExtractor(step=6, num_scales=2)
            >> _fisher_encoder(pca_components, (gmm_means, gmm_variances,
                                                gmm_weights), device)
            >> _Stack() >> linear_mapper(W, b, device))


def fitted_imagenet_predictor(sift_pca, sift_gmm, lcs_pca, lcs_gmm, W, b,
                              device: DeviceLike = "cuda") -> Pipeline:
    """ImageNetSiftLcsFV's images → class ids from the JAX package's
    fitted branches (each a PCA's components and a GMM's (means,
    variances, weights)) and class-weighted solver."""
    from .nodes.images.core import GrayScaler, PixelScaler
    from .nodes.images.descriptors import LCSExtractor
    from .nodes.images.extractors import ImageExtractor
    from .nodes.images.sift import SIFTExtractor
    from .pipelines.imagenet_sift_lcs_fv import _Concat
    from .pipelines.voc_sift_fisher import _Stack

    img = ImageExtractor().to_pipeline() >> PixelScaler()
    sift = (img >> GrayScaler() >> SIFTExtractor(step=6, num_scales=2)
            >> _fisher_encoder(sift_pca, sift_gmm, device))
    lcs = img >> LCSExtractor(stride=6) >> _fisher_encoder(lcs_pca, lcs_gmm,
                                                           device)
    return (Pipeline.gather([sift, lcs]) >> _Concat() >> _Stack()
            >> linear_mapper(W, b, device) >> MaxClassifier())


def naive_bayes_model(log_priors, log_cond,
                      device: DeviceLike = "cuda") -> NaiveBayesModel:
    return NaiveBayesModel(to_tensor(log_priors, device),
                           to_tensor(log_cond, device))


def logistic_regression_model(W, device: DeviceLike = "cuda"
                              ) -> LogisticRegressionModel:
    return LogisticRegressionModel(to_tensor(W, device))


def sparse_vectorizer(vocab) -> SparseFeatureVectorizer:
    """A vectorizer over a fitted vocabulary (feature → column)."""
    return SparseFeatureVectorizer(dict(vocab))


def fitted_text_predictor(vocab, model: Transformer,
                          ngram_orders=(1, 2)) -> Pipeline:
    """The text featurizer >> the vectorizer over ``vocab`` >> ``model``
    (from `naive_bayes_model` or `logistic_regression_model`). The CSR
    goes to the device of the documents' `HostDataset`."""
    from .pipelines.text_pipelines import text_featurizer

    return text_featurizer(ngram_orders) >> sparse_vectorizer(vocab) >> model


def fitted_newsgroups_predictor(vocab, log_priors, log_cond,
                                ngram_orders=(1, 2),
                                device: DeviceLike = "cuda") -> Pipeline:
    """Newsgroups' documents → class ids from a fitted vocabulary and
    naive Bayes model."""
    return fitted_text_predictor(
        vocab, naive_bayes_model(log_priors, log_cond, device),
        ngram_orders) >> MaxClassifier()


def crf_tagger_from_jax(tags, emit, trans, start, n_buckets: int,
                        device: DeviceLike = "cuda"):
    """A `LinearChainCRFTagger` decoding with a JAX tagger's weights: its
    sorted ``tags``, ``emit`` (n_buckets, T), ``trans`` (T, T) and
    ``start`` (T,)."""
    from .nodes.nlp.crf import LinearChainCRFTagger

    tagger = LinearChainCRFTagger(n_buckets=int(n_buckets), device=device)
    tagger.tags = [str(t) for t in tags]
    tagger.emit, tagger.trans, tagger.start = (
        to_tensor(a, tagger.device) for a in (emit, trans, start))
    return tagger


def perceptron_from_jax(tags, weights, trans=None):
    """A perceptron tagger from a JAX one's ``tags`` and ``weights``
    (feature → tag → weight): the `StructuredPerceptronTagger` where
    ``trans`` ((prev, tag) → weight) is given, else the greedy
    `AveragedPerceptronTagger`."""
    from .nodes.nlp.perceptron_tagger import (
        AveragedPerceptronTagger,
        StructuredPerceptronTagger,
    )

    tagger = (AveragedPerceptronTagger() if trans is None
              else StructuredPerceptronTagger())
    tagger.tags = list(tags)
    tagger.weights = {f: dict(ws) for f, ws in weights.items()}
    if trans is not None:
        tagger.trans = dict(trans)
    return tagger
