"""Where a VOC-sized class-weighted BCD fit spends its time on the card.

Run from the repository root on a machine with the card:

    python3 -m keystone_tpu_torch.nodes.learning.profile_weighted_ls

The fit is VOCSIFTFisher's at the reference's widths: 5,011 rows of
40,960 features (random normals from a fixed seed, made on the card),
the 20-class ±1 indicators of `_synthetic_voc(5011, 20, 0)`'s labels,
block 4096, one pass, λ 0.5, mixture weight 0.5. After a warm fit it
prints one JSON line: the card's name and power limit, the fit's wall
seconds (closed by a device sync), its kernels' device seconds and the
largest kernels by device time under `torch.profiler`; and the 20 class
systems of the first block factored and solved one at a time (the fit's
route) against one batched call, timed with CUDA events in the order
one at a time, batched, batched, one at a time.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

N_ROWS, N_FEATURES, N_CLASSES, BLOCK = 5011, 40960, 20, 4096
LAM, MIXTURE_WEIGHT = 0.5, 0.5


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_weighted_ls: CUDA is not available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ...data.dataset import Dataset
    from ...device import resolve_device
    from ...nodes.util.basic import ClassLabelIndicatorsFromIntArray
    from ...pipelines.voc_sift_fisher import _pad_labels, _synthetic_voc
    from .weighted_ls import BlockWeightedLeastSquaresEstimator

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((N_ROWS, N_FEATURES), generator=gen, device=dev)
    labels = _pad_labels(_synthetic_voc(N_ROWS, N_CLASSES, 0), N_CLASSES)
    Y = ClassLabelIndicatorsFromIntArray(N_CLASSES)(
        Dataset(labels, device=dev)).get()
    data = Dataset(X)
    est = BlockWeightedLeastSquaresEstimator(BLOCK, 1, LAM, MIXTURE_WEIGHT)
    est.fit(data, Y)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    est.fit(data, Y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est.fit(data, Y)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda kv: kv[1], reverse=True)

    # the first block's 20 class systems, as the fit forms them
    Xb = X[:, :BLOCK]
    member = (Y.array > 0).float()
    shared = (1 - MIXTURE_WEIGHT) / N_ROWS * (Xb.T @ Xb) + LAM * torch.eye(
        BLOCK, device=dev)
    G = torch.stack([torch.addmm(
        shared, Xb[m > 0].T, Xb[m > 0],
        alpha=MIXTURE_WEIGHT / max(int(m.sum()), 1)) for m in member.T])
    C = torch.randn((N_CLASSES, BLOCK, 1), generator=gen, device=dev)

    def one_at_a_time():
        for c in range(N_CLASSES):
            chol, _ = torch.linalg.cholesky_ex(G[c])
            torch.cholesky_solve(C[c], chol)

    def batched():
        chol, _ = torch.linalg.cholesky_ex(G)
        torch.cholesky_solve(C, chol)

    one_at_a_time(), batched()
    order = (("one_at_a_time", one_at_a_time), ("batched", batched),
             ("batched", batched), ("one_at_a_time", one_at_a_time))
    factor_ms = {}
    for name, fn in order:
        factor_ms.setdefault(name, []).append(_event_ms(fn))

    print(json.dumps(dict(
        card=_card(), rows=N_ROWS, features=N_FEATURES, classes=N_CLASSES,
        block=BLOCK, fit_wall_seconds=wall,
        profiled_kernel_seconds=sum(v for _, v in kernels) / 1e6,
        top_kernels_ms={k: v / 1e3 for k, v in kernels[:10]},
        class_systems_ms=factor_ms,
        class_sizes=[int(v) for v in member.sum(0).tolist()],
        flops_per_factorization=BLOCK ** 3 / 3)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
