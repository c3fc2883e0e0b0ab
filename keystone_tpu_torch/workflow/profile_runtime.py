"""What the workflow runtime's dispatch knobs cost whole pipeline runs on
the card: seconds and device memory per configuration and knob setting.

No module of the JAX package corresponds to this one. Each configuration
is one of ``chip_smoke.py``'s, at its sizes (CIFAR 50,000/10,000, MNIST
60,000/10,000, VOC 5,011/4,952 and ImageNet 5,000/2,000 synthetic
items): LinearPixels (build, fit, predict the training and the test
rows), MnistRandomFFT and VOCSIFTFisher and ImageNetSiftLcsFV (their
``run_on``, timed by their own clocks), RandomPatchCifar as ``run_fused``
and as the pipeline (fit, predict train and test), and
RandomPatchCifarAugmented (crops, fit, predict, the test views). Every
run builds its pipeline anew, as a user's one-shot run does. The
``*_applies`` and ``*_requests`` configurations fit LinearPixels or
RandomPatchCifar (untimed) and time 20 applies of the fitted pipeline to
the 10,000 test images, or 200 applies to 64 of them, as a server
answers requests.

Settings: ``default``; one knob of `ExecutionConfig` flipped from its
default at a time; everything off; and ``capture_at_first_call``, which captures a padded
loop's graph at its first call instead of its second
(`FusedBatchTransformer.eager_calls_before_capture` = 0). Each setting
runs ``--reps`` times, the settings in order and then in reverse,
alternating. A tree without `ExecutionConfig` (an older commit, given
by ``--root``) runs ``default`` only.

Per run: seconds, device memory allocated at its start, its peak, and
what stays allocated after it, before and after a garbage collection.
With ``--profile N``, one more run of each configuration (default
settings) under `cProfile`: the N functions with the most own host
time, their calls and seconds, keyed by file (relative to the root) and
name, so that two trees' profiles compare.

    python keystone_tpu_torch/workflow/profile_runtime.py \\
        [--root DIR] [--configs a,b] [--reps 2] [--profile N] [--out FILE]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _setup_path(root: str) -> None:
    # run as a file, the script's own directory would shadow top-level
    # modules with the package's (graph.py, env.py, ...)
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, os.path.abspath(root))


#: (test images, applies) of a fitted pipeline: the whole test set 20
#: times, and 200 requests of 64 images
APPLIES = {"applies": (10_000, 20), "requests": (64, 200)}

SETTINGS = {
    "default": {},
    "capture_at_first_call": {},
    "warmup_on": dict(aot_warmup=True),
    "dispatch_on": dict(concurrent_dispatch=True),
    "overlap_off": dict(overlap=False),
    "megafusion_off": dict(megafusion=False),
    "pad_off": dict(pad_chunks=False),
    "all_off": dict(aot_warmup=False, concurrent_dispatch=False,
                    overlap=False, megafusion=False, pad_chunks=False),
}


def _configs(dev):
    """{name: (warm, run)}: ``run()`` returns the run's seconds."""
    import torch

    from keystone_tpu_torch.data.dataset import Dataset, HostDataset
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.pipelines import (
        imagenet_sift_lcs_fv,
        mnist_random_fft,
        timit,
        voc_sift_fisher,
    )
    from keystone_tpu_torch.pipelines.cifar_variants import (
        LinearPixelsConfig,
        RandomPatchCifarAugmentedConfig,
        build_linear_pixels,
        build_random_patch_cifar_augmented,
        random_crops,
        score_center_corner_views,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        build_pipeline,
        run_fused,
    )

    train, test = synthetic_cifar(50_000, 10_000, noise=1.2, confusion=0.6,
                                  device=dev)
    config = RandomPatchCifarConfig(num_filters=256)
    evaluator = MulticlassClassifierEvaluator(config.num_classes)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def linear_pixels():
        lp = build_linear_pixels(train, LinearPixelsConfig())
        evaluator(lp(train.data), train.labels)
        evaluator(lp(test.data), test.labels)

    def pipeline():
        p = build_pipeline(train, config)
        evaluator(p(train.data), train.labels)
        evaluator(p(test.data), test.labels)

    ag_config = RandomPatchCifarAugmentedConfig(num_filters=256)

    def augmented():
        from keystone_tpu_torch.nodes.util.basic import MaxClassifier

        crops = random_crops(train, ag_config)
        scorer = build_random_patch_cifar_augmented(crops, ag_config)
        evaluator((scorer >> MaxClassifier())(crops.data), crops.labels)
        score_center_corner_views(scorer, test, ag_config, with_flips=False)

    mn_config = mnist_random_fft.MnistRandomFFTConfig()
    mn_train = timit.synthetic_timit(60_000, 784, 10, mn_config.seed,
                                     device=dev)
    mn_test = timit.synthetic_timit(10_000, 784, 10, mn_config.seed + 1,
                                    device=dev)
    vc_config = voc_sift_fisher.VOCSIFTFisherConfig(num_classes=20,
                                                    pca_dims=80, gmm_k=256)
    vc_train = voc_sift_fisher._synthetic_voc(5011, 20, vc_config.seed)
    vc_test = voc_sift_fisher._synthetic_voc(4952, 20, vc_config.seed + 1)
    im_config = imagenet_sift_lcs_fv.ImageNetSiftLcsFVConfig()
    im_train = imagenet_sift_lcs_fv._synthetic_imagenet(
        5000, im_config.num_classes, im_config.seed)
    im_test = imagenet_sift_lcs_fv._synthetic_imagenet(
        2000, im_config.num_classes, im_config.seed + 1)

    def host_warm(module, tr, te, cfg):
        return lambda: module.run_on(HostDataset(tr.items[:500]),
                                     HostDataset(te.items[:500]), cfg, dev)

    def applies(build, rows: int, times: int):
        """A fitted pipeline (fit untimed) applied ``times`` times to the
        first ``rows`` test images, as a server answers requests."""
        data = Dataset(test.data.array[:rows])

        def run():
            fitted = build().fit()
            torch.cuda.synchronize()
            return timed(lambda: [fitted.apply(data)
                                  for _ in range(times)])

        return run

    def build_lp():
        return build_linear_pixels(train, LinearPixelsConfig())

    def build_rpc():
        return build_pipeline(train, config)

    served = {}
    for name, build in (("linear_pixels", build_lp),
                        ("random_patch_cifar", build_rpc)):
        for kind, (rows, times) in APPLIES.items():
            run = applies(build, rows, times)
            served[f"{name}_{kind}"] = (run, run)
    return {
        **served,
        "linear_pixels": (linear_pixels, lambda: timed(linear_pixels)),
        "mnist": (lambda: mnist_random_fft.run_on(mn_train, mn_test,
                                                  mn_config),
                  lambda: mnist_random_fft.run_on(
                      mn_train, mn_test, mn_config)["seconds"]),
        "run_fused": (lambda: run_fused(train, test, config),
                      lambda: timed(lambda: run_fused(train, test, config))),
        "random_patch_cifar": (pipeline, lambda: timed(pipeline)),
        "augmented": (augmented, lambda: timed(augmented)),
        "voc": (host_warm(voc_sift_fisher, vc_train, vc_test, vc_config),
                lambda: voc_sift_fisher.run_on(vc_train, vc_test, vc_config,
                                               dev)["seconds"]),
        "imagenet": (host_warm(imagenet_sift_lcs_fv, im_train, im_test,
                               im_config),
                     lambda: imagenet_sift_lcs_fv.run_on(
                         im_train, im_test, im_config, dev)["seconds"]),
    }


def _profiled(run, top: int, root: str) -> dict:
    """``{"file(name)": [calls, own seconds]}`` of the ``top`` functions
    with the most own time in one run of ``run`` under `cProfile`."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    base = os.path.abspath(root) + os.sep
    own = {}
    for (path, _, fn), st in pstats.Stats(prof).stats.items():
        row = own.setdefault(f"{path.replace(base, '')}({fn})", [0, 0.0])
        row[0] += st[1]
        row[1] += st[2]
    return dict(sorted(own.items(), key=lambda kv: -kv[1][1])[:top])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    p.add_argument("--configs", default="")
    p.add_argument("--settings", default="")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--profile", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    _setup_path(args.root)
    import torch

    if not torch.cuda.is_available():
        print("profile_runtime: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from keystone_tpu_torch.workflow import PipelineEnv

    try:
        from keystone_tpu_torch.nodes.util.fusion import (
            FusedBatchTransformer,
        )
        from keystone_tpu_torch.workflow.env import config_override
        from keystone_tpu_torch.workflow.executor import drain_warmups
        settings = [s for s in SETTINGS
                    if not args.settings or s in args.settings.split(",")]
    except ImportError:  # a tree from before the runtime
        config_override = drain_warmups = FusedBatchTransformer = None
        settings = ["default"]
    dev = torch.device("cuda")
    configs = _configs(dev)
    names = [c for c in configs
             if not args.configs or c in args.configs.split(",")]
    out = dict(root=os.path.abspath(args.root), settings=settings,
               card=torch.cuda.get_device_name(0), configs={}, profiles={})
    for name in names:
        warm, run = configs[name]
        warm()
        torch.cuda.synchronize()
        rows = {s: [] for s in settings}
        order = settings + settings[::-1]
        for rep in range(args.reps):
            for setting in order[rep % 2 * len(settings):][:len(settings)]:
                PipelineEnv.reset()
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
                eager = None
                if FusedBatchTransformer is not None:
                    eager = FusedBatchTransformer.eager_calls_before_capture
                    if setting == "capture_at_first_call":
                        FusedBatchTransformer.eager_calls_before_capture = 0
                try:
                    if config_override is None:
                        seconds = run()
                    else:
                        with config_override(**SETTINGS[setting]):
                            seconds = run()
                        drain_warmups()
                finally:
                    if eager is not None:
                        FusedBatchTransformer.eager_calls_before_capture = \
                            eager
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                after = torch.cuda.memory_allocated()
                PipelineEnv.reset()
                after_reset = torch.cuda.memory_allocated()
                gc.collect()
                after_gc = torch.cuda.memory_allocated()
                rows[setting].append(dict(
                    seconds=seconds, start_bytes=start, peak_bytes=peak,
                    after_bytes=after, after_reset_bytes=after_reset,
                    after_gc_bytes=after_gc))
        out["configs"][name] = rows
        if args.profile:
            PipelineEnv.reset()
            out["profiles"][name] = _profiled(run, args.profile, args.root)
        summary = {s: dict(
            seconds=statistics.median(r["seconds"] for r in rows[s]),
            peak_gb=max(r["peak_bytes"] for r in rows[s]) / 1e9,
            kept_after_reset_gb=max(r["after_reset_bytes"] - r["start_bytes"]
                                    for r in rows[s]) / 1e9)
            for s in settings}
        print(f"{name}: {json.dumps(summary)}", flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
