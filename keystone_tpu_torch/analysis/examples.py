"""Registry of statically analyzable example pipelines.

Counterpart of `keystone_tpu/analysis/examples.py:1-32`: every example
application in `keystone_tpu_torch/pipelines/` has an ``analyzable()``
factory building its full predictor graph over abstract placeholder data
(`SpecDataset`); no data loads and no fit runs.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

#: name -> (module, factory attr). Factories return (pipeline, source_spec).
EXAMPLES: Dict[str, Tuple[str, str]] = {
    "MnistRandomFFT": ("keystone_tpu_torch.pipelines.mnist_random_fft",
                       "analyzable"),
    "RandomPatchCifar": ("keystone_tpu_torch.pipelines.random_patch_cifar",
                         "analyzable"),
    "LinearPixels": ("keystone_tpu_torch.pipelines.cifar_variants",
                     "analyzable"),
    "TimitPipeline": ("keystone_tpu_torch.pipelines.timit", "analyzable"),
    "NewsgroupsPipeline": ("keystone_tpu_torch.pipelines.text_pipelines",
                           "analyzable"),
    "VOCSIFTFisher": ("keystone_tpu_torch.pipelines.voc_sift_fisher",
                      "analyzable"),
    "ImageNetSiftLcsFV": ("keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv",
                          "analyzable"),
}


def build_example(name: str, device="cuda"):
    """Build one registered example, its weights on ``device``: returns
    ``(pipeline, source_spec)``."""
    module, attr = EXAMPLES[name]
    factory: Callable = getattr(importlib.import_module(module), attr)
    return factory(device=device)
