"""Field extractors from labeled images.

Counterpart of `keystone_tpu/nodes/images/extractors.py` (`:8-53`;
reference nodes/images/LabeledImageExtractors.scala:7-32). Over a
`HostDataset` each gives a `HostDataset` of the field; the images stay
host arrays until a batched stage stacks them.
"""

from __future__ import annotations

from ...data.dataset import HostDataset
from ...workflow.pipeline import Transformer


class _FieldExtractor(Transformer):
    """A field of each item; a device dataset passes through."""

    def apply(self, x):
        raise NotImplementedError

    def apply_batch(self, data):
        if isinstance(data, HostDataset):
            return data.map(self.apply)
        return data


class ImageExtractor(_FieldExtractor):
    """LabeledImage → image."""

    def apply(self, x):
        return x.image


class LabelExtractor(_FieldExtractor):
    """LabeledImage → label."""

    def apply(self, x):
        return x.label


class MultiLabelExtractor(_FieldExtractor):
    """MultiLabeledImage → its labels, a list."""

    def apply(self, x):
        return list(x.labels)


class MultiLabeledImageExtractor(_FieldExtractor):
    """MultiLabeledImage → image."""

    def apply(self, x):
        return x.image
