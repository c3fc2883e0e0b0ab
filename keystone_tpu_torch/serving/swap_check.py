"""Hot swaps under load, every answer held to the old and the new version.

No module of the JAX package corresponds to this one. It fits
RandomPatchCifar (`pipelines/random_patch_cifar.py`) on synthetic CIFAR
twice, on the labels and on the labels shifted by one class, each cut
before its argmax (its scores), and saves both. It serves the first to
``--clients`` threads through a `ServingRuntime` and swaps ``--swaps``
times, ``--gap`` seconds apart, to a fresh load of the other version, so
that every swap certifies and captures while the old version serves.
Each dispatch's rows are held to both versions' batch scores within
1e-4 of max|score|. A row that matches neither is reported with its
error against each version and its time against the swaps' windows; it
makes the command exit 1, as does a lost request.

    python -m keystone_tpu_torch.serving.swap_check [--swaps 16]
        [--gap 0.3] [--clients 8] [--train 50000] [--test 10000]
        [--filters 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict

import numpy as np

#: answers within this share of max|score| of a version are that version's
SCORE_RTOL = 1e-4


def _scores(pipeline):
    """``pipeline`` ending before its final `MaxClassifier`, if any."""
    from ..nodes.util.basic import MaxClassifier
    from ..workflow.pipeline import Pipeline

    g = pipeline.graph
    last = g.get_sink_dependency(pipeline.sink)
    if not isinstance(g.get_operator(last), MaxClassifier):
        return pipeline
    return Pipeline(g.set_sink_dependency(pipeline.sink,
                                          g.get_dependencies(last)[0]),
                    pipeline.source, pipeline.sink)


def swap_check(swaps: int = 16, gap: float = 0.3, clients: int = 8,
               n_train: int = 50_000, n_test: int = 10_000,
               filters: int = 256, requests: int = 2000,
               device="cuda") -> Dict:
    """The swaps' windows, the dispatches, and every answer from neither
    version (at most the first 50, and their count)."""
    from ..analysis import ServingEnvelope
    from ..data.dataset import Dataset
    from ..device import resolve_device
    from ..loaders.cifar_loader import synthetic_cifar
    from ..loaders.csv_loader import LabeledData
    from ..pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        build_pipeline,
    )
    from ..workflow import PipelineEnv
    from ..workflow.pipeline import FittedPipeline
    from . import NdarrayIngress, ServingRuntime

    device = resolve_device(device)
    train, test = synthetic_cifar(n_train, n_test, noise=1.2,
                                  confusion=0.6, device=device)
    config = RandomPatchCifarConfig(num_filters=filters)
    x_img = test.data.array[:requests].cpu().numpy()
    row_of = {x_img[j].tobytes(): j for j in range(len(x_img))}
    t_origin = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for tag, labels in (("a", train.labels.array),
                            ("b", (train.labels.array + 1)
                             % config.num_classes)):
            PipelineEnv.reset()
            fitted = _scores(build_pipeline(
                LabeledData(Dataset(labels), train.data), config)).fit()
            paths[tag] = os.path.join(tmp, f"{tag}.pkl")
            fitted.save(paths[tag])
            del fitted
        PipelineEnv.reset()
        live = FittedPipeline.load(paths["a"], device=device)
        refs = {tag: FittedPipeline.load(paths[tag], device=device).apply(
            Dataset(x_img, device=device)).array.cpu().numpy()
            for tag in paths}
        tol = SCORE_RTOL * float(np.abs(refs["a"]).max())
        version = {id(live): "a"}
        kept = [live]
        rt = ServingRuntime(live, NdarrayIngress(x_img.shape[1:]),
                            envelope=ServingEnvelope(max_batch=64,
                                                     slo_seconds=1.0),
                            name="RandomPatchCifar", device=device).start()
        apply_fn = rt._batcher.apply_fn
        neither, dispatches = [], [0]

        def checked(stacked):
            with rt._swap_lock:
                serving = version[id(rt._fitted)]
            t = time.perf_counter() - t_origin
            y = apply_fn(stacked)
            dispatches[0] += 1
            for i, row in enumerate(stacked):
                j = row_of[row.tobytes()]
                err = {tag: float(np.abs(y[i] - ref[j]).max())
                       for tag, ref in refs.items()}
                if min(err.values()) > tol:
                    neither.append(dict(
                        seconds=t, rows=len(stacked), row=j,
                        serving=serving, err_a=err["a"], err_b=err["b"],
                        finite=bool(np.isfinite(y[i]).all())))
            return y

        rt._batcher.apply_fn = checked
        stop, errors = threading.Event(), []

        def client(i):
            while not stop.is_set():
                try:
                    rt.submit(x_img[i % len(x_img)], timeout=120.0)
                except Exception as e:  # reported below
                    errors.append(repr(e))
                    return
                i += clients

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        windows = []
        try:
            for s in range(swaps):
                tag = "b" if s % 2 == 0 else "a"
                fresh = FittedPipeline.load(paths[tag], device=device)
                kept.append(fresh)  # ids stay unique while it is held
                version[id(fresh)] = tag
                time.sleep(gap)
                t0 = time.perf_counter() - t_origin
                rt.swap(fresh)
                windows.append(dict(to=tag, start=t0,
                                    end=time.perf_counter() - t_origin))
            time.sleep(gap)
        finally:
            stop.set()
            for t in threads:
                t.join()
            rt.stop()
    PipelineEnv.reset()
    return {"swaps": windows, "dispatches": dispatches[0],
            "tolerance": tol, "neither_count": len(neither),
            "neither": neither[:50], "errors": errors[:5]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.serving.swap_check",
        description=__doc__.splitlines()[0])
    p.add_argument("--swaps", type=int, default=16)
    p.add_argument("--gap", type=float, default=0.3,
                   help="seconds between swaps (default 0.3)")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--train", type=int, default=50_000)
    p.add_argument("--test", type=int, default=10_000)
    p.add_argument("--filters", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    report = swap_check(args.swaps, args.gap, args.clients, args.train,
                        args.test, args.filters,
                        requests=min(2000, args.test), device=args.device)
    json.dump(report, sys.stdout)
    print()
    return 1 if report["neither_count"] or report["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
