"""The image loaders: the port against the JAX package on the CPU.

- `utils/native_io.py::tar_index` equals `tarfile` and JAX's
  `native_io.tar_index` on ustar, pax and GNU archives, long names
  included (as `tests/test_native_io.py:54-96`).
- `decode_jpeg_batch` (the port's baseline decoder,
  `csrc/jpeg_baseline.cpp`, the same on every device) equals JAX's
  native (libjpeg) decode bit for bit on the committed images and over
  the subsamplings, sizes, quality factors, restart intervals and
  progressive scans PIL writes; a corrupt entry and a CMYK one are
  flagged by both alike, and an arithmetic-coded one is flagged.
- `voc_loader` and `imagenet_loader` on the committed tars give JAX's
  names, labels and pixels, ``max_images`` included; the gzip route
  gives the mapped route's pixels exactly and JAX's gzip (PIL) route's
  within its bound (mean |Δ| < 2.0, `tests/test_archive_loaders.py:77`).
- Both pipelines' ``run`` from the mini tars against JAX's: VOC's scores
  with JAX's fitted weights carried across by `convert.py` within
  1e-3 of their largest magnitude and the same mAP; ImageNet's fit end to
  end at JAX's accuracy; the CLIs and the launcher with ``--device cpu``.
"""

import gzip
import io
import os
import pathlib
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

import jax

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.loaders import image_loaders as jax_loaders
from keystone_tpu.nodes.images import (
    MultiLabeledImageExtractor as JaxMultiImage,
    ScalaGMMFisherVectorEstimator as JaxFVEstimator,
    SIFTExtractor as JaxSIFT,
)
from keystone_tpu.nodes.images.core import (
    GrayScaler as JaxGray,
    PixelScaler as JaxPixel,
)
from keystone_tpu.nodes.learning import (
    BlockWeightedLeastSquaresEstimator as JaxBWLS,
)
from keystone_tpu.nodes.learning.pca import PCAEstimator as JaxPCA
from keystone_tpu.nodes.stats import (
    ColumnSampler as JaxColumnSampler,
    NormalizeRows as JaxNormalizeRows,
    SignedHellingerMapper as JaxHellinger,
)
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromIntArray as JaxIndicatorsArray,
    MatrixVectorizer as JaxMatrixVectorizer,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.pipelines import imagenet_sift_lcs_fv as jax_imagenet
from keystone_tpu.pipelines import voc_sift_fisher as jax_voc
from keystone_tpu.utils import native_io as jax_native_io
from keystone_tpu_torch import __main__ as launcher
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import HostDataset
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders import (
    imagenet_loader,
    load_images_from_tar,
    voc_loader,
)
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
from keystone_tpu_torch.pipelines import voc_sift_fisher as voc
from keystone_tpu_torch.utils import native_io

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "tests" / "resources"
VOC_TAR = str(RES / "voc_mini.tar")
VOC_CSV = str(RES / "voc_mini_labels.csv")
IMAGENET_TAR = str(RES / "imagenet_mini.tar")
JPEG = RES / "000012.jpg"
LABELS_MAP = {"n01234567": 0, "n07654321": 1}
CPU = torch.device("cpu")
SCORE_RTOL = 1e-3
VOC_CFG = dict(num_classes=20, pca_dims=8, gmm_k=4, descriptor_samples=100)
IMAGENET_CFG = dict(num_classes=2, pca_dims=8, gmm_k=4)


def _jpeg(arr, **kw):
    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG", **kw)
    return bio.getvalue()


def _base():
    from PIL import Image

    return np.asarray(Image.open(JPEG).convert("RGB"))


@pytest.fixture(scope="module")
def labels_map_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "labels_map.csv"
    path.write_text("".join(f"{k},{v}\n" for k, v in LABELS_MAP.items()))
    return str(path)


# ---- the tar index ---------------------------------------------------------


def _write_tar(path, entries, fmt):
    with tarfile.open(path, "w", format=fmt) as tar:
        for name, data in entries:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("fmt,name", [
    (tarfile.USTAR_FORMAT, "cat/" + "u" * 90 + "/img.jpg"),
    (tarfile.PAX_FORMAT, "a" * 80 + "/" + "b" * 80 + "/img.jpg"),
    (tarfile.GNU_FORMAT, "g" * 120 + "/img.bin"),
], ids=["ustar", "pax", "gnu"])
def test_tar_index_matches_tarfile_and_jax(tmp_path, fmt, name):
    """Names, offsets and sizes of regular files (a directory entry and a
    second member skipped or listed as tarfile lists them)."""
    rng = np.random.default_rng(0)
    entries = [(name, _jpeg(rng.integers(0, 255, (16, 24, 3),
                                          dtype=np.uint8))),
               ("README.txt", b"not an image")]
    path = tmp_path / "t.tar"
    _write_tar(path, entries, fmt)
    buf = path.read_bytes()
    index = native_io.tar_index(buf)
    assert index == jax_native_io.tar_index(buf)
    with tarfile.open(path) as tar:
        want = [(m.name, m.offset_data, m.size) for m in tar if m.isfile()]
    assert index == want
    for (n, off, size), (_, data) in zip(index, entries):
        assert buf[off:off + size] == data


def test_tar_index_of_a_malformed_archive_is_none():
    buf = bytearray(RES.joinpath("voc_mini.tar").read_bytes())
    buf[124:136] = b"9" * 12  # a size field that is not octal
    assert native_io.tar_index(bytes(buf)) is None
    assert jax_native_io.tar_index(bytes(buf)) is None


# ---- JPEG decode ------------------------------------------------------------


def _entries(buf):
    return [(o, s) for _, o, s in native_io.tar_index(buf)]


@pytest.mark.parametrize("path", [VOC_TAR, IMAGENET_TAR],
                         ids=["voc", "imagenet"])
def test_decode_jpeg_batch_equals_jax(path):
    buf = pathlib.Path(path).read_bytes()
    entries = _entries(buf)
    got, ok = native_io.decode_jpeg_batch(buf, entries, "cpu")
    want, ok_jax = jax_native_io.decode_jpeg_batch(buf, entries)
    assert ok == ok_jax == len(entries)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.device == CPU
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


def test_decode_flags_a_corrupt_entry_as_jax_does():
    buf = bytearray(pathlib.Path(VOC_TAR).read_bytes())
    entries = _entries(bytes(buf))
    off, size = entries[1]
    buf[off + 2:off + 40] = b"\0" * 38  # the header past the SOI marker
    got, ok = native_io.decode_jpeg_batch(bytes(buf), entries, "cpu")
    want, ok_jax = jax_native_io.decode_jpeg_batch(bytes(buf), entries)
    assert ok == ok_jax == len(entries) - 1
    assert got[1] is None and want[1] is None
    for a, b in zip(got, want):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b)


def _baseline_cases():
    cases = []
    for sub in (0, 1, 2):
        for q in (50, 95):
            for h, w in ((333, 500), (9, 17), (1, 1), (65, 33)):
                cases.append((f"s{sub}-q{q}-{h}x{w}",
                              dict(sub=sub, q=q, h=h, w=w)))
    for rows in (1, 3):
        cases.append((f"restart-rows{rows}", dict(sub=2, q=85, h=333,
                                                   w=500, rows=rows)))
    cases.append(("restart-blocks7", dict(sub=1, q=85, h=120, w=97,
                                          blocks=7)))
    cases.append(("gray", dict(gray=True, q=80, h=333, w=500)))
    cases.append(("gray-odd", dict(gray=True, q=80, h=13, w=7)))
    # progressive scans (spectral selection and successive
    # approximation), and chroma planes at most 2 samples wide, which
    # libjpeg replicates instead of smoothing
    for sub in (0, 1, 2):
        for h, w in ((333, 500), (9, 17), (1, 1), (65, 33)):
            cases.append((f"prog-s{sub}-{h}x{w}",
                          dict(sub=sub, q=75, h=h, w=w, progressive=True)))
    cases.append(("prog-restart", dict(sub=2, q=85, h=120, w=97, blocks=5,
                                       progressive=True)))
    cases.append(("prog-optimized", dict(sub=1, q=95, h=200, w=300,
                                         progressive=True, optimize=True)))
    cases.append(("prog-gray", dict(gray=True, q=80, h=333, w=500,
                                    progressive=True)))
    for sub in (1, 2):
        for h, w in ((17, 1), (17, 2), (5, 3), (4, 4)):
            cases.append((f"narrow-s{sub}-{h}x{w}",
                          dict(sub=sub, q=50, h=h, w=w)))
    return cases


@pytest.mark.parametrize("case", [c for _, c in _baseline_cases()],
                         ids=[n for n, _ in _baseline_cases()])
def test_baseline_decoder_equals_libjpeg(case):
    """The port's decoder (`csrc/jpeg_baseline.cpp`) against JAX's native
    libjpeg decode, bit for bit."""
    from PIL import Image

    arr = _base()[:case["h"], :case["w"]]
    kw = dict(quality=case["q"])
    if case.get("gray"):
        img = Image.fromarray(arr).convert("L")
    else:
        img = Image.fromarray(arr)
        kw["subsampling"] = case["sub"]
    if "rows" in case:
        kw["restart_marker_rows"] = case["rows"]
    if "blocks" in case:
        kw["restart_marker_blocks"] = case["blocks"]
    for key in ("progressive", "optimize"):
        if case.get(key):
            kw[key] = True
    bio = io.BytesIO()
    img.save(bio, format="JPEG", **kw)
    data = bio.getvalue()
    got, ok = native_io.decode_jpeg_batch(data, [(0, len(data))], "cpu", 1)
    (want,), _ = jax_native_io.decode_jpeg_batch(data, [(0, len(data))])
    assert ok == 1
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_baseline_decoder_on_the_committed_images():
    for path in (VOC_TAR, IMAGENET_TAR, str(JPEG)):
        buf = pathlib.Path(path).read_bytes()
        entries = ([(0, len(buf))] if path.endswith(".jpg")
                   else _entries(buf))
        got, _ = native_io.decode_jpeg_batch(buf, entries, "cpu", 4)
        want, _ = jax_native_io.decode_jpeg_batch(buf, entries)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


def _unread_batch():
    """A baseline, a progressive and a CMYK JPEG of one image, and the
    decoder's batch of them."""
    from PIL import Image

    arr = _base()[:64, :96]
    bio = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(bio, format="JPEG")
    parts = [_jpeg(arr), _jpeg(arr, progressive=True), bio.getvalue()]
    offsets = np.cumsum([0] + [len(p) for p in parts])
    return b"".join(parts), [(int(o), len(p)) for o, p in zip(offsets, parts)]


def test_baseline_decoder_refuses_a_progressive_jpeg():
    """What the decoder refuses is flagged, not raised, and the batch's
    other entries decode: a progressive entry decodes to JAX's pixels; a
    CMYK one is flagged, as JAX's libjpeg flags it; one marked
    arithmetic-coded (its SOF2 marker made SOF10) is flagged."""
    buf, entries = _unread_batch()
    off, size = entries[1]
    arith = bytearray(buf[off:off + size])
    arith[arith.index(b"\xff\xc2") + 1] = 0xCA
    buf += bytes(arith)
    entries.append((len(buf) - size, size))
    got, ok = native_io.decode_jpeg_batch(buf, entries, "cpu", 2)
    want, _ = jax_native_io.decode_jpeg_batch(buf, entries[:3])
    assert ok == 2
    assert [g is None for g in got] == [False, False, True, True]
    assert want[2] is None
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_loaders_skip_an_entry_the_decoder_does_not_read(tmp_path):
    """A CMYK entry in a tar is skipped as JAX's native route skips it:
    the same rows and pixels."""
    buf, entries = _unread_batch()
    parts = [buf[o:o + s] for o, s in entries]
    path = tmp_path / "mixed.tar"
    _write_tar(path, [("n01234567/a.jpg", parts[0]),
                      ("n01234567/c.jpg", parts[2]),
                      ("n07654321/d.jpg", parts[0])], tarfile.USTAR_FORMAT)
    got = imagenet_loader(str(path), LABELS_MAP, device="cpu")
    want = jax_loaders.imagenet_loader(str(path), LABELS_MAP)
    assert [x.label for x in got.items] == [x.label for x in want.items] \
        == [0, 1]
    for a, b in zip(got.items, want.items):
        np.testing.assert_array_equal(a.image.numpy(), b.image)


# ---- the loaders --------------------------------------------------------------


def _rows_equal(got, want):
    assert [(n, lab) for n, _, lab in got] == [(n, lab)
                                               for n, _, lab in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_images", [None, 1, 2])
def test_load_images_from_tar_equals_jax(max_images):
    def label_fn(name):
        return LABELS_MAP.get(name.split("/")[0])

    got = load_images_from_tar(IMAGENET_TAR, label_fn, max_images,
                               device="cpu")
    want = jax_loaders.load_images_from_tar(IMAGENET_TAR, label_fn,
                                            max_images)
    _rows_equal(got, want)


@pytest.mark.parametrize("max_images", [None, 2])
def test_imagenet_loader_equals_jax(max_images):
    ds = imagenet_loader(IMAGENET_TAR, LABELS_MAP, max_images, device="cpu")
    want = jax_loaders.imagenet_loader(IMAGENET_TAR, LABELS_MAP, max_images)
    assert isinstance(ds, HostDataset) and ds.device == CPU
    assert [x.label for x in ds.items] == [x.label for x in want.items]
    for a, b in zip(ds.items, want.items):
        np.testing.assert_array_equal(a.image, b.image)
    assert len(ds.items) == (4 if max_images is None else max_images)


@pytest.mark.parametrize("max_images", [None, 1])
def test_voc_loader_equals_jax(max_images):
    ds = voc_loader(VOC_TAR, VOC_CSV, max_images=max_images, device="cpu")
    want = jax_loaders.voc_loader(VOC_TAR, VOC_CSV, max_images=max_images)
    assert [(x.filename, list(x.labels)) for x in ds.items] == \
        [(x.filename, list(x.labels)) for x in want.items]
    for a, b in zip(ds.items, want.items):
        np.testing.assert_array_equal(a.image, b.image)
    assert len(ds.items) == (3 if max_images is None else max_images)


def test_gzip_route_equals_the_mapped_route_and_jax_within_its_bound(
        tmp_path):
    gz = tmp_path / "imagenet_mini.tar.gz"
    gz.write_bytes(gzip.compress(pathlib.Path(IMAGENET_TAR).read_bytes()))

    def label_fn(name):
        return LABELS_MAP.get(name.split("/")[0])

    got = load_images_from_tar(str(gz), label_fn, device="cpu")
    mapped = load_images_from_tar(IMAGENET_TAR, label_fn, device="cpu")
    _rows_equal(got, mapped)
    pil = jax_loaders.load_images_from_tar(str(gz), label_fn)
    assert [(n, lab) for n, _, lab in got] == [(n, lab)
                                               for n, _, lab in pil]
    for (_, a, _), (_, b, _) in zip(got, pil):
        assert tuple(a.shape) == b.shape
        assert np.mean(np.abs(a.numpy() - b)) < 2.0


def test_a_tar_entry_that_is_not_a_jpeg_raises(tmp_path):
    path = tmp_path / "mixed.tar"
    _write_tar(path, [("n01234567/a.png", b"\x89PNG\r\n\x1a\n" + b"0" * 64)],
               tarfile.PAX_FORMAT)
    with pytest.raises(ValueError, match="not a JPEG"):
        imagenet_loader(str(path), LABELS_MAP, device="cpu")


def test_loaders_raise_without_a_card():
    """Left at ``device="cuda"``, the loaders raise with no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for call in (lambda: voc_loader(VOC_TAR, VOC_CSV),
                 lambda: imagenet_loader(IMAGENET_TAR, LABELS_MAP),
                 lambda: native_io.decode_jpeg_batch(b"", [], "cuda")):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


# ---- the pipelines from the mini tars -------------------------------------


def _jax_rows(ds):
    return np.asarray(ds.array)[:ds.count]


@pytest.fixture(scope="module")
def jax_voc_tar_fit():
    """JAX's VOCSIFTFisher on the mini tar (train = test), fit stage by
    stage as `jax_voc.run` chains it, on a one-device mesh."""
    with use_mesh(make_mesh(jax.devices()[:1])):
        cfg = jax_voc.VOCSIFTFisherConfig(train_tar=VOC_TAR,
                                          train_labels=VOC_CSV, **VOC_CFG)
        train = jax_loaders.voc_loader(VOC_TAR, VOC_CSV)

        def sift(ds):
            x = JaxGray().apply_batch(JaxPixel().apply_batch(
                JaxMultiImage().apply_batch(ds)))
            return JaxSIFT(step=6, num_scales=2).apply_batch(x)

        desc = sift(train)
        pca = JaxPCA(cfg.pca_dims).fit(
            JaxColumnSampler(cfg.descriptor_samples).apply_batch(desc))
        fv = JaxFVEstimator(cfg.gmm_k).fit(JaxColumnSampler(
            cfg.descriptor_samples).apply_batch(pca.apply_batch(desc)))
        x = fv.apply_batch(pca.apply_batch(desc))
        for node in (JaxMatrixVectorizer(), JaxHellinger(),
                     JaxNormalizeRows()):
            x = x.map(node.apply)
        X = x.stack(dtype=np.float32)
        Y = JaxIndicatorsArray(cfg.num_classes).apply_batch(
            JaxDataset(jax_voc._pad_labels(train, cfg.num_classes)))
        model = JaxBWLS(4096, 1, cfg.lam, cfg.mixture_weight).fit(X, Y)
        scores = _jax_rows(X) @ np.asarray(model.W) + np.asarray(model.b)
        g = fv.gmm
        return dict(pca=np.asarray(pca.components),
                    gmm=(np.asarray(g.means), np.asarray(g.variances),
                         np.asarray(g.weights)),
                    W=np.asarray(model.W), b=np.asarray(model.b),
                    scores=scores, run_map=jax_voc.run(cfg)["map"])


def test_voc_from_the_tar_with_jax_weights_gives_jax_scores(jax_voc_tar_fit):
    f = jax_voc_tar_fit
    predictor = convert.fitted_voc_predictor(f["pca"], *f["gmm"], f["W"],
                                             f["b"], device="cpu")
    test = voc_loader(VOC_TAR, VOC_CSV, device="cpu")
    scores = predictor(test).get().numpy()
    want = f["scores"]
    np.testing.assert_array_equal(scores.argmax(1), want.argmax(1))
    np.testing.assert_allclose(scores, want, rtol=0,
                               atol=SCORE_RTOL * np.abs(want).max())
    labels = [x.labels for x in test.items]
    got_map = MeanAveragePrecisionEvaluator(20)(torch.tensor(scores),
                                                labels).mean()
    assert got_map == pytest.approx(f["run_map"])


def test_voc_run_from_the_tar_matches_jax(jax_voc_tar_fit):
    out = voc.run(voc.VOCSIFTFisherConfig(train_tar=VOC_TAR,
                                          train_labels=VOC_CSV, **VOC_CFG),
                  device="cpu")
    assert out["map"] == pytest.approx(jax_voc_tar_fit["run_map"])
    assert tuple(out["scores"].array.shape) == (3, 20)


def test_imagenet_run_from_the_tar_matches_jax(labels_map_csv):
    cfg = dict(train_tar=IMAGENET_TAR, labels_map_csv=labels_map_csv,
               **IMAGENET_CFG)
    with use_mesh(make_mesh(jax.devices()[:1])):
        want = jax_imagenet.run(jax_imagenet.ImageNetSiftLcsFVConfig(**cfg))
    out = imagenet.run(imagenet.ImageNetSiftLcsFVConfig(**cfg), device="cpu")
    assert out["test_accuracy"] == want["test_accuracy"]


def test_voc_cli_from_the_tar_on_the_cpu(capsys):
    voc.main(["--train-tar", VOC_TAR, "--train-labels", VOC_CSV,
              "--test-tar", VOC_TAR, "--test-labels", VOC_CSV,
              "--pca-dims", "8", "--gmm-k", "4", "--device", "cpu"])
    assert "mAP=" in capsys.readouterr().out


def test_imagenet_cli_from_the_tar_on_the_cpu(capsys, labels_map_csv):
    imagenet.main(["--train-tar", IMAGENET_TAR, "--labels-map-csv",
                   labels_map_csv, "--test-tar", IMAGENET_TAR,
                   "--num-classes", "2", "--device", "cpu"])
    assert "accuracy=" in capsys.readouterr().out


def test_launcher_runs_voc_from_the_tar_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "VOCSIFTFisher",
         "--trainTar", VOC_TAR, "--trainLabels", VOC_CSV, "--pca-dims", "8",
         "--gmm-k", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert "mAP=" in out.stdout


def test_launcher_runs_imagenet_from_the_tar(labels_map_csv, capsys):
    assert launcher.main(["ImageNetSiftLcsFV", "--train-tar", IMAGENET_TAR,
                          "--labels-map-csv", labels_map_csv,
                          "--num-classes", "2", "--device", "cpu"]) == 0
    assert "accuracy=" in capsys.readouterr().out


def test_chip_smoke_pins_equal_jax_s_native_decode():
    """`chip_smoke.py`'s pinned pixel sums and digests, and its loader
    rows, are what the JAX package's native (libjpeg) decode and loaders
    give here."""
    import hashlib

    sys.path.insert(0, str(REPO))
    import chip_smoke

    for archive, pins in chip_smoke.DECODE_PINS.items():
        buf = (RES / archive).read_bytes()
        if archive.endswith(".tar"):
            index = jax_native_io.tar_index(buf)
            names = [n for n, _, _ in index]
            entries = [(o, s) for _, o, s in index]
        else:
            names, entries = [archive], [(0, len(buf))]
        images, _ = jax_native_io.decode_jpeg_batch(buf, entries)
        assert names == [p[0] for p in pins]
        for (name, shape, total, sha), img in zip(pins, images):
            u = img.astype(np.uint8)
            assert (tuple(u.shape), int(u.astype(np.int64).sum()),
                    hashlib.sha256(u.tobytes()).hexdigest()[:16]) == \
                (shape, total, sha), name
    voc_rows = [(os.path.basename(x.filename), list(x.labels))
                for x in jax_loaders.voc_loader(VOC_TAR, VOC_CSV).items]
    assert voc_rows == chip_smoke.VOC_MINI_ROWS
    im_rows = [x.label for x in jax_loaders.imagenet_loader(
        IMAGENET_TAR, chip_smoke.IMAGENET_MINI_LABELS).items]
    assert im_rows == chip_smoke.IMAGENET_MINI_ROWS
