"""Pipeline launcher: a pipeline name and its flags → the app's main.

Counterpart of `keystone_tpu/__main__.py` (`REGISTRY` `:17-31`, `main`
`:67-`; reference bin/run-pipeline.sh:1-55) for the pipelines the port
has:

    python -m keystone_tpu_torch MnistRandomFFT --num-ffts 4 --device cpu
    python -m keystone_tpu_torch pipelines.speech.TimitPipeline --n-synth 4000
    python -m keystone_tpu_torch RandomPatchCifar --num-filters 256
    python -m keystone_tpu_torch VOCSIFTFisher --n-synth 60 --device cpu
    python -m keystone_tpu_torch NewsgroupsPipeline --nSynth 400 --device cpu

Names take the reference's qualified form or the bare class name; the
reference apps' camelCase flags (``--numFFTs``) are accepted. The port
has every pipeline the JAX package registers, so `NOT_PORTED` is empty; a
name listed there, and the JAX launcher's multi-host flags, stop the
launcher with a message: nothing falls back.
"""

from __future__ import annotations

import importlib
import re
import sys

_PIPELINES = "keystone_tpu_torch.pipelines."

#: reference class name -> (module, main, leading arguments)
REGISTRY = {
    "pipelines.images.mnist.MnistRandomFFT":
        (_PIPELINES + "mnist_random_fft", "main", ()),
    "pipelines.images.cifar.RandomPatchCifar":
        (_PIPELINES + "random_patch_cifar", "main", ()),
    "pipelines.images.cifar.LinearPixels":
        (_PIPELINES + "cifar_variants", "main", ("linear-pixels",)),
    "pipelines.images.cifar.RandomCifar":
        (_PIPELINES + "cifar_variants", "main", ("random-cifar",)),
    "pipelines.images.cifar.RandomPatchCifarKernel":
        (_PIPELINES + "cifar_variants", "main", ("kernel",)),
    "pipelines.images.cifar.RandomPatchCifarAugmented":
        (_PIPELINES + "cifar_variants", "main", ("augmented",)),
    "pipelines.images.cifar.RandomPatchCifarAugmentedKernel":
        (_PIPELINES + "cifar_variants", "main", ("augmented-kernel",)),
    "pipelines.speech.TimitPipeline": (_PIPELINES + "timit", "main", ()),
    "pipelines.images.voc.VOCSIFTFisher":
        (_PIPELINES + "voc_sift_fisher", "main", ()),
    "pipelines.images.imagenet.ImageNetSiftLcsFV":
        (_PIPELINES + "imagenet_sift_lcs_fv", "main", ()),
    "pipelines.text.NewsgroupsPipeline":
        (_PIPELINES + "text_pipelines", "main", ("newsgroups",)),
    "pipelines.text.AmazonReviewsPipeline":
        (_PIPELINES + "text_pipelines", "main", ("amazon",)),
    "pipelines.nlp.StupidBackoffPipeline":
        (_PIPELINES + "text_pipelines", "main", ("stupid-backoff",)),
}

#: registered in the JAX package, not ported yet (none: every one is)
NOT_PORTED: tuple = ()

MULTIHOST_FLAGS = ("--coordinator", "--num-processes", "--process-id")


def _short(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _normalize_flags(argv):
    """The reference apps' scopt camelCase flags, as the JAX launcher
    takes them: ``--numFFTs 4`` → ``--num-ffts 4``."""
    out = []
    for a in argv:
        if a.startswith("--"):
            flag, eq, val = a.partition("=")
            flag = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "-", flag).lower()
            a = flag + eq + val
        out.append(a)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("Available pipelines:")
        for name in sorted(REGISTRY):
            print(f"  {name}")
        return 0
    for a in argv:
        if a.partition("=")[0] in MULTIHOST_FLAGS:
            raise SystemExit(f"{a.partition('=')[0]}: multi-host runs are "
                             "not ported yet; the port runs on one card")
    name, rest = argv[0], _normalize_flags(argv[1:])
    entry = REGISTRY.get(name) or {
        _short(k): v for k, v in REGISTRY.items()}.get(name)
    if entry is None:
        if name in NOT_PORTED or name in map(_short, NOT_PORTED):
            raise SystemExit(f"pipeline {name!r} is not ported yet; it runs "
                             "in the JAX package (python -m keystone_tpu)")
        print(f"unknown pipeline {name!r}; run with --help to list",
              file=sys.stderr)
        return 2
    module, fn_name, lead = entry
    getattr(importlib.import_module(module), fn_name)(list(lead) + rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
