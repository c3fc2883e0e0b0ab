"""Graph replays on one thread while the capturing thread warms new loops.

No module of the JAX package corresponds to this one. It isolates one
suspect of a hot swap's answer from neither version (ROADMAP queue 3):
the new version is warmed and captured (`utils/graphs.py::CapturedLoop`)
on the thread that captured the old one, while the dispatcher replays
the old one, so the two may share what is kept per (thread, stream),
such as cuBLAS's workspace of the capture stream. For each product shape
(rows × K) @ (K × N) + b it captures the loops of the ladder 1 … 64 on
this thread, then replays them from a second thread, each answer checked
bit for bit against its first replay, while this thread captures new
loops of the same shapes with other weights for ``seconds``. It prints a
JSON report and exits 1 on a wrong replay.

    python -m keystone_tpu_torch.serving.capture_race [--seconds 6]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Dict, Sequence, Tuple

import torch

#: (K, N): RandomPatchCifar's BCD map (2048 features, 10 classes), a
#: longer and a VOC-wide reduction, and a wide output
SHAPES = ((2048, 10), (8192, 10), (40960, 20), (2048, 256))
LADDER = (1, 2, 4, 8, 16, 32, 64)


def capture_race(seconds: float = 6.0,
                 shapes: Sequence[Tuple[int, int]] = SHAPES,
                 device="cuda") -> Dict:
    """Each shape's replays, wrong replays (and the first one's rows and
    error) and the loops captured meanwhile."""
    from ..device import resolve_device
    from ..utils.graphs import CapturedLoop

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("capture_race needs the card: CUDA graphs")
    out = []
    for k, n in shapes:
        g = torch.Generator().manual_seed(0)
        W = torch.randn(k, n, generator=g).to(dev)
        b = torch.randn(n, generator=g).to(dev)
        X = torch.randn(LADDER[-1], k, generator=g).to(dev)
        old = {r: CapturedLoop(lambda x, W=W: x @ W + b, (r, k),
                               torch.float32, dev) for r in LADDER}
        want = {r: old[r](X[:r]).cpu() for r in LADDER}
        stop = threading.Event()
        stats = dict(replays=0, wrong=0, first_wrong=None)

        def dispatcher():
            while not stop.is_set():
                for r in LADDER:
                    y = old[r](X[:r]).cpu()
                    stats["replays"] += 1
                    if not torch.equal(y, want[r]):
                        stats["wrong"] += 1
                        if stats["first_wrong"] is None:
                            stats["first_wrong"] = dict(
                                rows=r, err=float((y - want[r]).abs().max()))

        thread = threading.Thread(target=dispatcher, name="race-batcher")
        thread.start()
        warms, t0 = 0, time.monotonic()
        try:
            while time.monotonic() - t0 < seconds:
                W2 = torch.randn(k, n, device=dev)
                for r in LADDER:
                    CapturedLoop(lambda x, W2=W2: x @ W2 + b, (r, k),
                                 torch.float32, dev)
                warms += 1
        finally:
            stop.set()
            thread.join()
        out.append(dict(K=k, N=n, ladders_captured=warms, **stats))
    return {"shapes": out, "wrong": sum(s["wrong"] for s in out),
            "replays": sum(s["replays"] for s in out)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.serving.capture_race",
        description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=6.0,
                   help="seconds of captures for each shape (default 6)")
    args = p.parse_args(argv)
    report = capture_race(args.seconds)
    json.dump(report, sys.stdout)
    print()
    return 1 if report["wrong"] else 0


if __name__ == "__main__":
    sys.exit(main())
