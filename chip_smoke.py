#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases, each printed on a line of its own:

1. device   - the card (nvidia-smi name and power limit), torch and CUDA.
2. build    - nvcc builds every kernel of the main path from csrc/.
3. kernels  - each kernel against its plain PyTorch version on the card,
              at the main path's shapes and at ragged ones, with its
              error, tolerance and time (CUDA events, median of reps).
4. slice    - RandomPatchCifar at full width (256 filters) on 50,000
              synthetic training and 10,000 test images, as the JAX
              package's bench times its headline; test accuracy must
              reach 0.72, and the fused conv+rectify+pool kernel must
              have run once per microbatch.
5. cross    - the same 2048 images through the fused kernel and through
              an fp32 conv followed by the rectify+pool kernel.

Then a ``kernels`` JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero; with no card it exits non-zero before any phase.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, fp32
# CUDA-core rate, HBM3 bandwidth
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

# the main path's shapes: one 2048-image microbatch, the headline data
HEADLINE_N = 2048
N_TRAIN, N_TEST = 50_000, 10_000

# bf16 operands: max error over max |plain|, the limit the JAX package's
# tests hold its Pallas kernel to (tests/test_pallas_ops.py:162-164)
K1_TOL = 2e-2
K2_TOL = 1e-5   # fp32 sums in another order: max error over max |plain|


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(title: str, /, **fields) -> None:
    print(f"{title}: {json.dumps(fields)}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` single calls timed with CUDA events, warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / scale


def k1_bound_ms(n, h, w, c, patch, k, gy, gx):
    """(ms, bound_by): the conv's products at the bf16 peak against each
    input read once and each output written once at the HBM rate."""
    ph, pw = h - patch + 1, w - patch + 1
    flops = 2.0 * n * ph * pw * c * patch * patch * k
    nbytes = 4.0 * (n * h * w * c + c * patch * patch * k + 2 * k
                    + n * gy * gx * 2 * k)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def k2_bound_ms(n, h, w, k, pool, gy, gx):
    """(ms, bound_by): six fp32 operations per window value (two
    subtractions, two maxima, two sums) against the bytes moved."""
    flops = 6.0 * n * gy * gx * pool * pool * k
    nbytes = 4.0 * (n * h * w * k + n * gy * gx * 2 * k)
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.device import resolve_device
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.nodes.images.core import (
        ImageVectorizer,
        PixelScaler,
        Pooler,
        SymmetricRectifier,
    )
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer
    from keystone_tpu_torch.ops import _build, kernels
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        build_pipeline,
        run_staged,
    )

    # ---- 1. device -------------------------------------------------------
    dev = resolve_device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, name=name,
          count=torch.cuda.device_count(),
          tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
          tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    regs = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                if "registers" in ln or "spill" in ln]
            for n in _build.SOURCES}
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          per_kernel=seconds, ptxas=regs)

    # ---- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha, mv, pool, stride, patch = 0.25, 0.0, 14, 13, 6

    def conv_inputs(n, k):
        x = torch.rand((n, 32, 32, 3), generator=gen, device=dev)
        kern = torch.randn((patch, patch, 3, k), generator=gen,
                           device=dev) / 10.0
        cs = torch.randn((k,), generator=gen, device=dev)
        bs = torch.randn((k,), generator=gen, device=dev)
        return x, kern, kernels.hwio_to_cmajor(kern).contiguous(), cs, bs

    k1_checks, k1 = [], None  # the first geometry is the headline
    for n, k, normalize in ((HEADLINE_N, 256, True), (37, 256, True),
                            (64, 16, True), (128, 256, False)):
        x, kern, g, cs, bs = conv_inputs(n, k)
        got = kernels.conv_rectify_pool(x, g, cs, bs, alpha, mv, pool,
                                        stride, normalize, patch)
        torch.cuda.synchronize()
        want = kernels.conv_rectify_pool_reference(
            x, kern, cs, bs, alpha, mv, pool, stride, normalize)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"conv_rectify_pool: bad output at n={n} k={k}")
        err, rel = rel_err(got, want)
        check(rel <= K1_TOL, f"conv_rectify_pool n={n} k={k} "
              f"normalize={normalize}: relative error {rel} > {K1_TOL}")
        k1_checks.append(dict(n=n, k=k, normalize=normalize,
                              max_abs_err=err, rel_err=rel))
        if k1 is None:
            k1 = dict(max_abs_err=err, rel_err=rel)
            k1["ms"] = time_ms(lambda: kernels.conv_rectify_pool(
                x, g, cs, bs, alpha, mv, pool, stride, normalize, patch))
            k1["plain_ms"] = time_ms(
                lambda: kernels.conv_rectify_pool_reference(
                    x, kern, cs, bs, alpha, mv, pool, stride, normalize))
            xb = x.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
            wb = kern.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
            k1["conv2d_bf16_conv_only_ms"] = time_ms(lambda: F.conv2d(xb, wb))
            k1["bound_ms"], k1["bound_by"] = k1_bound_ms(
                n, 32, 32, 3, patch, k, 2, 2)
            del xb, wb
        del x, kern, g, cs, bs, got, want

    k2_checks, k2 = [], None  # the first geometry is the headline
    for n, h, w, k, p, s, a, m in ((HEADLINE_N, 27, 27, 256, 14, 13, 0.25,
                                    0.0),
                                   (37, 27, 27, 100, 14, 13, 0.25, 0.0),
                                   (5, 10, 14, 4, 5, 3, 0.1, 0.05)):
        x = torch.randn((n, h, w, k), generator=gen, device=dev)
        got = kernels.rectify_pool(x, a, m, p, s)
        torch.cuda.synchronize()
        want = kernels.rectify_pool_reference(x, a, m, p, s)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"rectify_pool: bad output at {(n, h, w, k)}")
        err, rel = rel_err(got, want)
        check(rel <= K2_TOL, f"rectify_pool {(n, h, w, k)}: relative error "
              f"{rel} > {K2_TOL}")
        k2_checks.append(dict(shape=[n, h, w, k], max_abs_err=err,
                              rel_err=rel))
        if k2 is None:
            k2 = dict(max_abs_err=err, rel_err=rel)
            k2["ms"] = time_ms(lambda: kernels.rectify_pool(x, a, m, p, s))
            k2["plain_ms"] = time_ms(
                lambda: kernels.rectify_pool_reference(x, a, m, p, s))
            gy, gx = kernels.pooled_grid(h, w, p, s)
            k2["bound_ms"], k2["bound_by"] = k2_bound_ms(n, h, w, k, p, gy,
                                                         gx)
        del x, got, want
    torch.cuda.empty_cache()
    phase("kernels", conv_rectify_pool=dict(headline=k1, checks=k1_checks,
                                            tolerance_rel=K1_TOL),
          rectify_pool=dict(headline=k2, checks=k2_checks,
                            tolerance_rel=K2_TOL))

    # ---- 4. the slice ----------------------------------------------------
    t0 = time.perf_counter()
    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device=dev)
    data_seconds = time.perf_counter() - t0
    config = RandomPatchCifarConfig(num_filters=256)
    evaluator = MulticlassClassifierEvaluator(config.num_classes)
    # warm pass at the same shapes, as the JAX bench warms its headline
    warm = build_pipeline(train, config)
    evaluator(warm(train.data), train.labels)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    predictor = build_pipeline(train, config)
    train_metrics = evaluator(predictor(train.data), train.labels)
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    test_metrics = evaluator(predictor(test.data), test.labels)
    k1_launches = kernels.conv_rectify_pool.launches
    stages, _ = run_staged(train, config, evaluator)
    microbatches = (math.ceil(train.data.count / config.microbatch)
                    + math.ceil(test.data.count / config.microbatch))
    phase("slice", train_seconds=train_seconds,
          images_per_sec=train.data.count / train_seconds,
          train_error=train_metrics.error,
          test_accuracy=test_metrics.accuracy,
          data_seconds=data_seconds,
          peak_mem_bytes=torch.cuda.max_memory_allocated(),
          conv_rectify_pool_launches=k1_launches,
          microbatches=microbatches, stage_seconds=stages, card=card)
    check(test_metrics.accuracy >= 0.72,
          f"test accuracy {test_metrics.accuracy} below 0.72")
    check(k1_launches >= microbatches,
          f"conv_rectify_pool launched {k1_launches} times for "
          f"{microbatches} microbatches")

    # ---- 5. cross-check: fused kernel vs fp32 conv + rectify_pool --------
    featurizer = predictor.nodes[0]
    conv = featurizer.stages[1]
    imgs = Dataset(train.data.array[:config.microbatch])
    fused = featurizer.apply_batch(imgs).array
    convolved = conv.apply_batch(PixelScaler().apply_batch(imgs))
    kernels.reset_launches()
    staged = FusedBatchTransformer(
        [SymmetricRectifier(alpha=config.alpha),
         Pooler(config.pool_stride, config.pool_size, pool_fn="sum"),
         ImageVectorizer()],
        microbatch=config.microbatch).apply_batch(convolved).array
    torch.cuda.synchronize()
    k2_launches = kernels.rectify_pool.launches
    err, rel = rel_err(fused, staged)
    phase("cross", max_abs_err=err, rel_err=rel, tolerance_rel=K1_TOL,
          rectify_pool_launches=k2_launches)
    check(k2_launches >= 1, "the rectify+pool path did not launch its kernel")
    check(rel <= K1_TOL, f"fused vs staged featurizer: relative error {rel}")

    record = {"kernels": [
        dict(name="conv_rectify_pool", route="cuda",
             source="keystone_tpu_torch/csrc/conv_rectify_pool.cu",
             replaces="keystone_tpu/ops/pallas_kernels.py:591",
             launches=k1_launches, max_abs_err=k1["max_abs_err"],
             rel_err=k1["rel_err"], tolerance_rel=K1_TOL, ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             conv2d_bf16_conv_only_ms=k1["conv2d_bf16_conv_only_ms"]),
        dict(name="rectify_pool", route="cuda",
             source="keystone_tpu_torch/csrc/rectify_pool.cu",
             replaces="keystone_tpu/ops/pallas_kernels.py:132",
             also_replaces="keystone_tpu/ops/chain_kernels.py:346",
             launches=k2_launches, max_abs_err=k2["max_abs_err"],
             rel_err=k2["rel_err"], tolerance_rel=K2_TOL, ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
    ]}
    print(json.dumps(record), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
