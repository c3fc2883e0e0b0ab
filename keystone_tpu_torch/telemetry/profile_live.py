"""What the live telemetry plane costs a request, part by part, in host
microseconds.

No module of the JAX package corresponds to this one. Each part runs
alone in a loop, ``--calls`` times a repetition, and the fastest of
``--reps`` repetitions is kept: the whole `watchdog.request_scope` with
the live plane on and off, and what its exit does (the flight ring's
span, the histogram and the latency sketch) and what a request's kernels
and megafused program count (`metrics.tally`, `instrument.
record_dispatch`). The plane is host code, so the numbers are those of
the machine's CPU.

With ``--requests N``, it also fits LinearPixels on ``chip_smoke.py``'s
synthetic CIFAR (50,000 training images) on ``--device`` and times N
requests of 64 test images under each setting of `SETTINGS` (the live
plane off; on; on with one part of its exit left out; off and on with
the garbage collector off), the settings in order and then in reverse,
then profiles one loop live off and one live on under `cProfile`: the
calls and host seconds of the functions whose own time differs most.

    python -m keystone_tpu_torch.telemetry.profile_live [--calls N]
        [--reps R] [--requests N] [--device cuda] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _best_us(fn, calls: int, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    return best * 1e6


def measure(calls: int = 20_000, reps: int = 7) -> dict:
    from ..workflow.env import config_override
    from . import flight, instrument, metrics, streaming, watchdog

    def scope():
        with watchdog.request_scope(64, pipeline="profile_live"):
            pass

    counter = metrics.counter("profile_live.count")
    hist = metrics.histogram("profile_live.seconds")
    ring = flight.ensure_flight()
    parts = {
        "request_scope_live_on": scope,
        "padded_shape": lambda: watchdog._padded_shape(64),
        "flight_span": lambda: ring.record_complete(
            "apply_request", "request", 0.0, 1e-4, error=False, batch=64,
            chunk_shape=64, pipeline="profile_live"),
        "histogram": lambda: hist.observe(1e-4),
        "latency_sketch": lambda: streaming.observe_apply(
            "profile_live", 64, 1e-4),
        "tally": lambda: metrics.tally(counter),
        "record_dispatch": instrument.record_dispatch,
        "empty_call": lambda: None,
    }
    out = {name: _best_us(fn, calls, reps) for name, fn in parts.items()}
    with config_override(live_telemetry=False):
        out["request_scope_live_off"] = _best_us(scope, calls, reps)
    streaming.reset_live()
    return out


#: the request loop's settings: (live plane on, parts left out of a
#: request's exit, garbage collector on)
SETTINGS = {
    "live_off": (False, (), True),
    "live_on": (True, (), True),
    "live_on_no_flight_span": (True, ("flight_span",), True),
    "live_on_no_sketch": (True, ("latency_sketch",), True),
    "live_on_no_histogram": (True, ("histogram",), True),
    "live_off_gc_off": (False, (), False),
    "live_on_gc_off": (True, (), False),
}


def _left_out(parts):
    """A context leaving ``parts`` of the request scope's exit out."""
    import contextlib

    from . import flight, metrics, watchdog

    stack = contextlib.ExitStack()
    for part in parts:
        owner, name = {
            "flight_span": (flight.FlightRecorder, "record_complete"),
            "latency_sketch": (watchdog, "_observe_apply"),
            "histogram": (metrics.Histogram, "_observe"),
        }[part]
        saved = getattr(owner, name)
        setattr(owner, name, lambda *a, **k: None)
        stack.callback(setattr, owner, name, saved)
    return stack


def _requests(n: int, device: str) -> dict:
    """Seconds of ``n`` requests live off and on, and the functions whose
    own host time differs most between a profiled loop of each."""
    import cProfile
    import pstats

    import torch

    from ..data.dataset import Dataset
    from ..loaders.cifar_loader import synthetic_cifar
    from ..pipelines.cifar_variants import (
        LinearPixelsConfig,
        build_linear_pixels,
    )
    from ..workflow.env import config_override
    from . import streaming

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    train, test = synthetic_cifar(50_000, 10_000, noise=1.2, confusion=0.6,
                                  device=device)
    fitted = build_linear_pixels(train, LinearPixelsConfig()).fit()
    x = test.data.array
    requests = [Dataset(x[(i * 64) % (x.shape[0] - 63):][:64])
                for i in range(n)]

    def serve():
        for d in requests:
            fitted.apply(d)

    for _ in range(3):  # the rung's eager call, capture, replay
        fitted.apply(requests[0])
    import gc

    seconds = {name: [] for name in SETTINGS}
    for name in list(SETTINGS) + list(SETTINGS)[::-1]:
        live, parts, collect = SETTINGS[name]
        streaming.reset_live()
        with config_override(live_telemetry=live), _left_out(parts):
            if not collect:
                gc.disable()
            try:
                sync()
                t0 = time.perf_counter()
                serve()
                sync()
                seconds[name].append(time.perf_counter() - t0)
            finally:
                gc.enable()
    own = {}
    for live in (False, True):
        with config_override(live_telemetry=live):
            prof = cProfile.Profile()
            prof.enable()
            serve()
            sync()
            prof.disable()
        for (path, line, fn), row in pstats.Stats(prof).stats.items():
            key = f"{path.rsplit('/', 2)[-1]}:{line}({fn})"
            own.setdefault(key, {})["on" if live else "off"] = (row[1],
                                                                row[2])

    def delta(v):
        return v.get("on", (0, 0.0))[1] - v.get("off", (0, 0.0))[1]

    top = sorted(own.items(), key=lambda kv: -abs(delta(kv[1])))[:25]
    return dict(seconds=seconds, requests=n, rows=64, device=device,
                profiled_own_seconds={
                    k: dict(calls_off=v.get("off", (0, 0))[0],
                            calls_on=v.get("on", (0, 0))[0],
                            off=v.get("off", (0, 0.0))[1],
                            on=v.get("on", (0, 0.0))[1]) for k, v in top})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=20_000)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--requests", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    result = dict(us=measure(args.calls, args.reps), calls=args.calls,
                  reps=args.reps)
    if args.requests:
        result["requests"] = _requests(args.requests, args.device)
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
