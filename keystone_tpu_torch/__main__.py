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
name listed there stops the launcher with a message: nothing falls back.

The multi-host flags (`_pop_multihost_flags`, JAX's `:36-72`) join a
process group before the pipeline runs, one process per card (NCCL;
gloo with the pipeline's ``--device cpu``); the pipeline then fits
data-parallel over every rank:

    python -m keystone_tpu_torch --coordinator host:port \
        --num-processes 4 --process-id $I RandomPatchCifar ...
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


def _pop_multihost_flags(argv):
    """The launcher-level multi-host flags, anywhere on the command line
    (JAX `:36-72`): ``--coordinator`` joins the job by `init_multihost`,
    on the device the pipeline's ``--device`` names (default the card).
    Returns the rest of ``argv``."""
    opts, rest = {}, []
    it = iter(argv)
    for a in it:
        flag, eq, inline = a.partition("=")
        if flag in MULTIHOST_FLAGS:
            val = inline if eq else next(it, None)
            if not val:
                raise SystemExit(f"{flag} requires a value")
            opts[flag.lstrip("-").replace("-", "_")] = val
        else:
            rest.append(a)
    if opts:
        if "coordinator" not in opts:
            raise SystemExit(
                "--num-processes/--process-id require --coordinator "
                "(single-host runs need none of these flags)"
            )
        if "num_processes" not in opts or "process_id" not in opts:
            raise SystemExit(
                "--coordinator: a multi-host run needs --num-processes and "
                "--process-id (nothing on the machine names them)")
        from .parallel import init_multihost

        device = "cuda"
        for i, a in enumerate(rest):
            flag, eq, inline = a.partition("=")
            if flag == "--device":
                device = inline if eq else rest[i + 1]
        init_multihost(
            coordinator_address=opts["coordinator"],
            num_processes=int(opts["num_processes"]),
            process_id=int(opts["process_id"]),
            device=device,
        )
    return rest


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
    argv = _pop_multihost_flags(argv)
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
