"""Text-format loaders.

Counterpart of `timit_loader` in `keystone_tpu/loaders/text_loaders.py`
(`:67-81`; reference loaders/TimitFeaturesDataLoader.scala:44-69). The
module's text-corpus loaders are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..device import DeviceLike, resolve_device
from .csv_loader import LabeledData, parse_csv


def timit_loader(features_path: str, labels_path: str,
                 device: DeviceLike = "cuda") -> LabeledData:
    """Pre-featurized TIMIT: a features CSV (a row a frame) and a sparse
    label file of ``index,label`` lines; frames it does not name get
    label 0."""
    device = resolve_device(device)
    feats = parse_csv(features_path)
    labels = np.zeros(feats.shape[0], np.int32)
    with open(labels_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx, lab = line.split(",")
            labels[int(idx)] = int(lab)
    return LabeledData.from_arrays(labels, feats, device)
