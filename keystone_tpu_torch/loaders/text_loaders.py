"""Text and speech-feature loaders.

Counterpart of `keystone_tpu/loaders/text_loaders.py`: `TextLabeledData`,
`newsgroups_loader` and `amazon_reviews_loader` (`:23-64`; reference
NewsgroupsDataLoader.scala:9-52, AmazonReviewsDataLoader.scala:6-27)
and `timit_loader` (`:67-81`; TimitFeaturesDataLoader.scala:44-69). The
text loaders give host datasets of strings and class ids; the strings
stay on the host (`nodes/nlp/text.py`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..data.dataset import HostDataset
from ..device import DeviceLike, resolve_device
from .csv_loader import LabeledData, parse_csv


@dataclass
class TextLabeledData:
    labels: HostDataset  # int class ids
    data: HostDataset  # raw strings
    class_names: Optional[List[str]] = field(default=None)


def newsgroups_loader(path: str) -> TextLabeledData:
    """A directory of class subdirectories of text files, classes
    numbered in sorted order and files read in sorted order
    (NewsgroupsDataLoader.scala:44-50)."""
    classes = sorted(d for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d)))
    texts, labels = [], []
    for label, cls in enumerate(classes):
        cdir = os.path.join(path, cls)
        for fname in sorted(os.listdir(cdir)):
            fpath = os.path.join(cdir, fname)
            if os.path.isfile(fpath):
                with open(fpath, errors="replace") as f:
                    texts.append(f.read())
                labels.append(label)
    return TextLabeledData(HostDataset(labels), HostDataset(texts), classes)


def amazon_reviews_loader(path: str, threshold: float = 3.5
                          ) -> TextLabeledData:
    """JSON lines with ``reviewText`` and the ``overall`` rating; label
    1 when the rating exceeds ``threshold``
    (AmazonReviewsDataLoader.scala:19-26)."""
    texts, labels = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            texts.append(row.get("reviewText", ""))
            labels.append(1 if float(row.get("overall", 0)) > threshold
                          else 0)
    return TextLabeledData(HostDataset(labels), HostDataset(texts))


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
