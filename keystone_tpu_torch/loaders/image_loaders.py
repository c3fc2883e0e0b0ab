"""Archive image loaders.

Counterpart of `keystone_tpu/loaders/image_loaders.py:34-169`
(reference loaders/ImageLoaderUtils.scala:56-94, ImageNetLoader.scala:
11-39, VOCLoader.scala:15-53): `load_images_from_tar`,
`imagenet_loader` and `voc_loader`, producing a `HostDataset` of
`LabeledImage` or `MultiLabeledImage` whose batched stages stack on the
given device.

An uncompressed tar is mapped into memory and indexed by the port's tar
index (`utils/native_io.py::tar_index`); its entries are decoded in
chunks that honour ``max_images``, without a copy of the archive. A
gzip tar goes through `tarfile`, its member reads prefetched on a
producer thread (`utils/batching.py::prefetch_iterator`) while the
consumer decodes. Either way the decoder is the port's baseline decoder
(`csrc/jpeg_baseline.cpp`) on host threads, its pixels bit for bit the
JAX package's native (libjpeg) decode; the images are float32 (H, W, 3)
tensors on the given device, one copy from the host for a CUDA device.
The JAX package's PIL route has no counterpart: an entry that is not a
JPEG raises, and a JPEG that does not decode (corrupt, or progressive,
arithmetic-coded, 12-bit or CMYK) is skipped, as JAX's native route
skips the ones its libjpeg does not decode.
"""

from __future__ import annotations

import mmap
import os
import tarfile
from typing import Callable, Dict, List, Optional

from ..data.dataset import HostDataset
from ..device import DeviceLike, resolve_device
from ..utils.images import LabeledImage, MultiLabeledImage
from ..utils.native_io import decode_jpeg_batch, tar_index

#: the two bytes every JPEG starts with (its SOI marker)
_SOI = b"\xff\xd8"


def _not_jpeg(path: str, name: str) -> ValueError:
    return ValueError(f"{path}: entry {name!r} is not a JPEG; the port "
                      "decodes JPEG only")


def load_images_from_tar(path: str,
                         label_fn: Callable[[str], Optional[object]],
                         max_images: Optional[int] = None,
                         device: DeviceLike = "cuda") -> List[tuple]:
    """``[(name, image, label)]`` for the archive's entries whose
    ``label_fn(name)`` is not None, in archive order, at most
    ``max_images`` of them (`:34-77`)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        gzipped = f.read(2) == b"\x1f\x8b"
    if not gzipped:
        return _load_tar_mapped(path, label_fn, max_images, device)
    from ..utils.batching import prefetch_iterator

    def raw_entries():
        # the producer's side: the sequential tar walk and member reads
        with tarfile.open(path, "r:*") as tar:
            for member in tar:
                if not member.isfile():
                    continue
                label = label_fn(member.name)
                if label is None:
                    continue
                f = tar.extractfile(member)
                if f is None:
                    continue
                yield member.name, f.read(), label

    out = []
    for name, data, label in prefetch_iterator(raw_entries()):
        if data[:2] != _SOI:
            raise _not_jpeg(path, name)
        (img,), _ = decode_jpeg_batch(data, [(0, len(data))], device)
        if img is None:
            continue
        out.append((name, img, label))
        if max_images and len(out) >= max_images:
            break
    return out


def _load_tar_mapped(path: str, label_fn, max_images: Optional[int],
                     device) -> List[tuple]:
    """The mapped archive's index, then chunked batch decodes (`:80-126`);
    a chunk is twice ``max_images`` (at least 256), so that images that
    fail to decode do not leave the result short."""
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    try:
        index = tar_index(buf)
        if index is None:
            raise ValueError(f"{path}: not a tar archive the index reads")
        keep = []
        for name, off, size in index:
            label = label_fn(name)
            if label is None or size < 4:
                continue
            if buf[off:off + 2] != _SOI:
                raise _not_jpeg(path, name)
            keep.append((name, off, size, label))
        out = []
        chunk = max(2 * max_images, 256) if max_images else len(keep)
        for start in range(0, len(keep), max(chunk, 1)):
            part = keep[start:start + chunk]
            images, _ = decode_jpeg_batch(
                buf, [(o, s) for _, o, s, _ in part], device)
            for (name, _, _, label), img in zip(part, images):
                if img is None:
                    continue
                out.append((name, img, label))
                if max_images and len(out) >= max_images:
                    return out
        return out
    finally:
        buf.close()


def imagenet_loader(path: str, labels_map: Dict[str, int],
                    max_images: Optional[int] = None,
                    device: DeviceLike = "cuda") -> HostDataset:
    """A tar of images named ``<synset>/<file>`` or ``<synset>_<file>``
    (`:129-147`) → `HostDataset` of `LabeledImage`."""

    def label_fn(name: str):
        base = os.path.basename(name)
        synset = (os.path.dirname(name)
                  or (base.split("_")[0] if "_" in base else None))
        return labels_map.get(synset)

    device = resolve_device(device)
    rows = load_images_from_tar(path, label_fn, max_images, device)
    return HostDataset([LabeledImage(img, label) for _, img, label in rows],
                       device=device)


def read_voc_labels(labels_csv: str) -> Dict[str, List[int]]:
    """``filename,class_id`` rows → file name → its class ids, in the
    file's order (`:154-162`)."""
    labels: Dict[str, List[int]] = {}
    with open(labels_csv) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fname, cid = line.rsplit(",", 1)
            labels.setdefault(os.path.basename(fname), []).append(int(cid))
    return labels


def voc_loader(path: str, labels_csv: str, num_classes: int = 20,
               max_images: Optional[int] = None,
               device: DeviceLike = "cuda") -> HostDataset:
    """A VOC tar joined with its ``filename,class_id`` labels CSV
    (`:150-169`) → `HostDataset` of `MultiLabeledImage`."""
    labels = read_voc_labels(labels_csv)

    def label_fn(name: str):
        return labels.get(os.path.basename(name))

    device = resolve_device(device)
    rows = load_images_from_tar(path, label_fn, max_images, device)
    return HostDataset(
        [MultiLabeledImage(img, lab, name) for name, img, lab in rows],
        device=device)
