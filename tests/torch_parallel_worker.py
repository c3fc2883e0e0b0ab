"""One rank of the port's multi-process tests: a gloo group on the CPU.

Spawned by `tests/test_torch_parallel.py` and `tests/test_torch_multihost.py`
(through `run_job`), as `tests/multihost_worker.py` is for the JAX package:

    python tests/torch_parallel_worker.py JOB RANK WORLD PORT OUT_DIR

Each rank joins the group by `parallel.init_multihost` (gloo, a 60 s
timeout, so a lost peer fails the job instead of hanging it), runs the
job's checks, and writes ``OUT_DIR/JOB-RANK.json`` (flags and numbers)
and ``OUT_DIR/JOB-RANK.npz`` (arrays) for the parent to assert on. The
worker imports no JAX: the parent holds the results to JAX's.
"""

from __future__ import annotations

import fcntl
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

#: a collective's wait for its peers, and a whole job's
GROUP_TIMEOUT_S = 60.0
JOB_TIMEOUT_S = 180.0

#: RandomPatchCifar at the tests' small width: 16 filters, two 64-wide
#: BCD blocks, 601/201 synthetic images (counts that 2 and 4 ranks pad)
CIFAR_CFG = dict(num_filters=16, block_size=64, microbatch=64,
                 sample_patches=5000, seed=3)
CIFAR_N = (601, 201)


def k4_chain(microbatch: int = 128):
    """``PixelScaler >> GrayScaler >> ImageVectorizer >>`` a scaler over
    6×6×3 images: one run that K4 plans, whose scaler re-zeroes padded
    rows (seeded mean and std)."""
    import torch

    from keystone_tpu_torch.nodes.images.core import (
        GrayScaler,
        ImageVectorizer,
        PixelScaler,
    )
    from keystone_tpu_torch.nodes.stats.scalers import StandardScalerModel
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    rng = np.random.default_rng(9)
    mean = torch.tensor(rng.normal(size=36), dtype=torch.float32)
    std = torch.tensor(rng.uniform(0.5, 2.0, size=36), dtype=torch.float32)
    return FusedBatchTransformer([PixelScaler(), GrayScaler(),
                                  ImageVectorizer(),
                                  StandardScalerModel(mean, std)],
                                 microbatch=microbatch)


def k4_images() -> np.ndarray:
    """1,001 seeded 6×6×3 images for `k4_chain`."""
    return (np.random.default_rng(8).random((1001, 6, 6, 3))
            * 255.0).astype(np.float32)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(argvs, out_dir: str, timeout: float = JOB_TIMEOUT_S):
    """Run one process per argv (each after ``python``), their output to
    files under ``out_dir``; kill them all at ``timeout`` seconds.
    Returns the outputs; raises AssertionError naming a failed rank."""
    # one thread a rank: the ranks share the host with the other tests
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    logs = [os.path.join(out_dir, f"rank{i}.log") for i in range(len(argvs))]
    procs = []
    for argv, log in zip(argvs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable] + argv, stdout=f, stderr=subprocess.STDOUT,
                env=env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    for i, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {i} exited {p.returncode} (killed at the {timeout:.0f} s "
            f"deadline if negative):\n{outs[i][-4000:]}")
    return outs


def once(shared: str, name: str, make) -> str:
    """``shared/name``, a directory every pytest worker sees, after
    ``make(directory)`` has filled it: the first caller runs it under a
    file lock, later callers find it done."""
    out_dir = os.path.join(shared, name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(os.path.join(out_dir, "done")):
                make(out_dir)
                open(os.path.join(out_dir, "done"), "w").close()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out_dir


def run_job(job: str, world: int, shared: str):
    """The job's results, one ``(json, npz)`` pair a rank, run once for
    every pytest worker (`once`)."""
    out_dir = once(shared, f"{job}-{world}",
                   lambda d: _run(job, world, d))
    return [(json.load(open(os.path.join(out_dir, f"{job}-{r}.json"))),
             dict(np.load(os.path.join(out_dir, f"{job}-{r}.npz"))))
            for r in range(world)]


def _run(job: str, world: int, out_dir: str) -> None:
    port = _free_port()
    spawn([[os.path.abspath(__file__), job, str(r), str(world), str(port),
            out_dir] for r in range(world)], out_dir)


# ------------------------------------------------------------------- ranks


def collectives_job(rank, world, port, out_dir, res, arr):
    """The collectives, the mesh, `Dataset` placement and padding, the
    solvers, the guard and the per-process counters."""
    import torch

    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.nodes.learning import (
        ApproximatePCAEstimator,
        BlockLeastSquaresEstimator,
        DenseLBFGSwithL2,
        LinearMapEstimator,
        ZCAWhitenerEstimator,
    )
    from keystone_tpu_torch.nodes.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.nodes.util.fusion import (
        FusedBatchTransformer,
        MegafusedBatchTransformer,
    )
    from keystone_tpu_torch.workflow.pipeline import Estimator
    from keystone_tpu_torch.parallel import (
        DATA_AXIS,
        P,
        all_gather_rows,
        broadcast,
        co_sharded,
        current_mesh,
        dataset_from_process_local,
        global_data_mesh,
        init_multihost,
        n_data_shards,
        reshard,
        tree_aggregate,
        tree_reduce_sum,
    )
    from keystone_tpu_torch.telemetry import (
        counter,
        record_dispatch,
        trace_run,
    )

    mesh = global_data_mesh()
    res["mesh_axes"] = list(mesh.mesh_dim_names)
    res["data_shards"] = n_data_shards(mesh)
    res["current_is_default"] = current_mesh() is current_mesh()
    res["init_noop"] = init_multihost() == world
    res["init_again"] = init_multihost(f"127.0.0.1:{port}", world, rank,
                                       device="cpu") == world

    x = np.arange(64 * 5, dtype=np.float32).reshape(64, 5)
    arr["reduce_sum"] = tree_reduce_sum(
        Dataset.from_numpy(x, mesh=mesh)).numpy()
    x2 = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    agg = tree_aggregate(Dataset.from_numpy(x2, mesh=mesh), lambda r: {
        "sum": r.sum(dim=0), "sumsq": (r * r).sum(dim=0),
        "n": torch.tensor(float(r.shape[0]))})
    arr["agg_sum"], arr["agg_sumsq"] = agg["sum"].numpy(), agg["sumsq"].numpy()
    res["agg_n"] = float(agg["n"])
    arr["bcast"] = broadcast(torch.full((4, 4), float(rank) + 1.0),
                             mesh).numpy()
    with trace_run() as tracer:
        broadcast(torch.ones(2), mesh)
        tree_reduce_sum(Dataset.from_numpy(x, mesh=mesh))
    res["collective_spans"] = [[r.name, r.args["bytes"]] for r in
                               tracer.spans if r.cat == "collective"]
    a = Dataset.from_numpy(np.ones((16, 2), np.float32), mesh=mesh)
    b = Dataset.from_numpy(np.zeros((16, 2), np.float32), mesh=mesh)
    rep = reshard(a, P())
    res["co_sharded"] = co_sharded(a, b)
    res["co_sharded_rep"] = co_sharded(a, rep)
    res["reshard_identity"] = (reshard(a, P(DATA_AXIS)) is a
                               and reshard(rep, P()) is rep)
    arr["reshard_rep"] = rep.numpy()
    arr["reshard_back"] = reshard(rep, P(DATA_AXIS)).numpy()
    g = all_gather_rows(Dataset.from_numpy(
        np.arange(32, dtype=np.float32).reshape(32, 1), mesh=mesh))
    arr["gathered"] = g.numpy()
    local = np.arange(rank * 8, rank * 8 + 8, dtype=np.float32).reshape(8, 1)
    ds = dataset_from_process_local(local, mesh=mesh)
    res["local_count"] = ds.count
    arr["local_rows"] = ds.numpy()
    try:
        dataset_from_process_local(local, global_count=8 * world - 8,
                                   mesh=mesh)
        res["local_bad_count_raises"] = world == 1
    except ValueError:
        res["local_bad_count_raises"] = True
    if world > 1:
        from keystone_tpu_torch.parallel import n_model_shards

        m2 = global_data_mesh(model_shards=2)
        res["model_mesh"] = [list(m2.mesh_dim_names), n_data_shards(m2),
                             n_model_shards(m2)]

    # padding: 1,001 rows over `world` shards
    rng = np.random.default_rng(5)
    X = rng.normal(size=(1001, 6)).astype(np.float32)
    Y = (X @ rng.normal(size=(6, 3)) + 0.1 * rng.normal(size=(1001, 3))
         ).astype(np.float32)
    dX = Dataset.from_numpy(X, mesh=mesh)
    dY = Dataset.from_numpy(Y, mesh=mesh)
    arr["pad_numpy"] = dX.numpy()
    res["pad_padded_count"] = dX.padded_count
    res["pad_valid"] = float(tree_reduce_sum(
        Dataset.from_numpy(np.ones((1001, 1), np.float32), mesh=mesh))[0])
    scaler = StandardScaler().fit(dX)
    arr["pad_mean"], arr["pad_std"] = scaler.mean.numpy(), scaler.std.numpy()
    arr["pad_scaled"] = scaler.apply_batch(dX).numpy()
    # a fused chain whose scaler re-zeroes padded rows before the mapper
    W3 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(6, 3)).astype(np.float32))
    b3 = torch.ones(3)
    chain = FusedBatchTransformer([scaler, BlockLinearMapper(W3, b3)],
                                  microbatch=128)
    out = chain.apply_batch(dX)
    arr["pad_chain"] = out.numpy()
    res["pad_chain_padded_rows_are_b"] = bool(
        (out.array[~dX.mask] == b3).all())
    res["pad_scaled_padded_rows_zero"] = bool(
        (scaler.apply_batch(dX).array[~dX.mask] == 0).all())
    # a chain that K4 plans: the mask goes into the kernel's scaler
    # stage, through the eager loop and the megafused one
    k4 = k4_chain()
    res["pad_k4_planned"] = list(k4.planned_kernel)
    dI = Dataset.from_numpy(k4_images(), mesh=mesh)
    out = k4.apply_batch(dI)
    arr["pad_k4"] = out.numpy()
    res["pad_k4_padded_rows_zero"] = bool(
        (out.array[~dI.mask] == 0).all())
    out = MegafusedBatchTransformer([k4], microbatch=128).apply_batch(dI)
    arr["pad_k4_megafused"] = out.numpy()
    res["pad_k4_megafused_padded_rows_zero"] = bool(
        (out.array[~dI.mask] == 0).all())
    m = LinearMapEstimator(lam=0.1).fit(dX, dY)
    arr["pad_exact_W"], arr["pad_exact_b"] = m.W.numpy(), m.b.numpy()
    m = BlockLeastSquaresEstimator(2, 3, lam=0.1).fit(dX, dY)
    arr["pad_bcd_W"], arr["pad_bcd_b"] = m.W.numpy(), m.b.numpy()
    m = DenseLBFGSwithL2(lam=0.5, num_iters=15).fit(dX, dY)
    arr["pad_lbfgs_W"], arr["pad_lbfgs_b"] = m.W.numpy(), m.b.numpy()
    preds = rng.integers(0, 4, size=1001).astype(np.int64)
    actual = rng.integers(0, 4, size=1001).astype(np.int64)
    arr["pad_confusion"] = MulticlassClassifierEvaluator(4)(
        Dataset.from_numpy(preds, mesh=mesh),
        Dataset.from_numpy(actual, mesh=mesh)).confusion

    # the solvers of `tests/test_parallel.py`
    rng = np.random.default_rng(1)
    X = rng.normal(size=(96, 6)).astype(np.float32)
    Y = X @ rng.normal(size=(6, 3)).astype(np.float32)
    m = LinearMapEstimator(lam=0.0).fit(Dataset.from_numpy(X, mesh=mesh),
                                        Dataset.from_numpy(Y, mesh=mesh))
    arr["exact_W"], arr["exact_b"] = m.W.numpy(), m.b.numpy()
    rng = np.random.default_rng(7)
    X = rng.normal(size=(96, 24)).astype(np.float32)
    W = rng.normal(size=(24, 3)).astype(np.float32)
    Y = X @ W + 0.01 * rng.normal(size=(96, 3)).astype(np.float32)
    m = BlockLeastSquaresEstimator(block_size=8, num_iter=4, lam=0.1).fit(
        Dataset.from_numpy(X, mesh=mesh), Dataset.from_numpy(Y, mesh=mesh))
    arr["bcd_W"], arr["bcd_b"] = m.W.numpy(), m.b.numpy()
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    Y = X @ rng.normal(size=(16, 2)).astype(np.float32)
    m = DenseLBFGSwithL2(lam=0.5, num_iters=15).fit(
        Dataset.from_numpy(X, mesh=mesh), Dataset.from_numpy(Y, mesh=mesh))
    arr["lbfgs_W"], arr["lbfgs_b"] = m.W.numpy(), m.b.numpy()

    # ZCA and the approximate PCA fit every rank's rows; an estimator
    # that is not marked mesh-aware still raises
    pts = Dataset.from_numpy(np.random.default_rng(2).normal(
        size=(41, 3)).astype(np.float32), mesh=mesh)
    for name, est in (("zca", ZCAWhitenerEstimator()),
                      ("approx_pca", ApproximatePCAEstimator(2))):
        try:
            model = est.fit(pts)
            res[f"guard_{name}"] = ""
        except NotImplementedError as e:
            res[f"guard_{name}"] = str(e)
            continue
        if name == "zca":
            arr["zca_whitener"] = model.whitener.numpy()
            arr["zca_means"] = model.means.numpy()
        else:
            arr["approx_pca"] = model.components.numpy()

    class Unmarked(Estimator):
        """An estimator outside the package whose fit reads one
        process's rows."""

        def fit(self, data):
            return data.array.sum()

    try:
        Unmarked().fit(pts)
        res["guard_unmarked"] = ""
    except NotImplementedError as e:
        res["guard_unmarked"] = str(e)

    record_dispatch()
    res["counters"] = {
        f"p{r}": counter(f"dispatch.programs_executed.p{r}").value
        for r in range(world)}


def cifar_job(rank, world, port, out_dir, res, arr):
    """RandomPatchCifar at the small width over the ranks: filters from
    JAX's draws (``cifar-reference/draws.npz``, which the parent writes
    beside the job's directory), the staged
    pipeline and `fused_fit` on them, `run_fused` on the port's own
    draws; a distributed checkpoint of the fitted pipeline, and a
    corrupted sidecar."""
    import torch

    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.parallel import barrier, global_data_mesh
    from keystone_tpu_torch.pipelines import random_patch_cifar as rpc
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    mesh = global_data_mesh()
    config = rpc.RandomPatchCifarConfig(**CIFAR_CFG)
    train, test = synthetic_cifar(*CIFAR_N, noise=1.2, confusion=0.6,
                                  device="cpu", mesh=mesh)
    draws = np.load(os.path.join(out_dir, "..", "cifar-reference",
                                 "draws.npz"))
    filters, whitener = rpc.learn_filters_from_indices(
        train.data, *(torch.from_numpy(draws[k]) for k in
                      ("img_idx", "patch_idx", "filter_idx")),
        config.patch_size, config.patch_steps)
    arr["filters"] = filters.numpy()
    arr["whitener"] = whitener.whitener.numpy()
    arr["means"] = whitener.means.numpy()

    evaluator = MulticlassClassifierEvaluator(10)
    PipelineEnv.reset()
    predictor = rpc.build_pipeline(train, config, learned=(filters, whitener))
    res["staged_test_accuracy"] = evaluator(predictor(test.data),
                                            test.labels).accuracy
    arr["staged_preds"] = predictor(test.data).get().numpy()
    model = predictor.fitted(1)
    arr["staged_W"], arr["staged_b"] = model.W.numpy(), model.b.numpy()

    W, b, _, conf_test, _ = rpc.fused_fit(train, test, filters, whitener,
                                          config)
    arr["fused_W"], arr["fused_b"] = W.numpy(), b.numpy()
    arr["fused_conf_test"] = conf_test.numpy()
    stages, metrics = rpc.run_staged(train, config, evaluator)
    res["run_staged_total"] = metrics.total
    own, own_whitener = rpc.learn_filters(train.data, config)
    arr["own_filters"] = own.numpy()
    arr["own_whitener"] = own_whitener.whitener.numpy()
    fused = rpc.run_fused(train, test, config)
    res["run_fused_test_accuracy"] = fused["test_accuracy"]
    arr["run_fused_W"] = fused["W"].numpy()

    PipelineEnv.reset()
    fitted = rpc.build_pipeline(train, config,
                                learned=(filters, whitener)).fit()
    path = os.path.join(out_dir, "..", f"ckpt-{world}")
    fitted.save(path, format="dcp")
    loaded = FittedPipeline.load(path, device="cpu")
    arr["ckpt_before"] = fitted.apply(test.data).numpy()
    arr["ckpt_after"] = loaded.apply(test.data).numpy()
    barrier()
    if rank == 0:
        with open(os.path.join(path, "arrays_id.txt"), "w") as f:
            f.write("not-the-skeleton-id")
    barrier()
    try:
        FittedPipeline.load(path, device="cpu")
        res["corrupt_sidecar"] = ""
    except RuntimeError as e:
        res["corrupt_sidecar"] = str(e)


def _placement_chain(mesh, res, arr):
    """``RandomSignNode(16) >> LinearRectifier >> LinearMapper(16→10)
    >> MaxClassifier`` on 61 rows, stage by stage: each output's
    placement and bytes beside what the static passes predict for the
    same pipeline on the mesh's layout."""
    import torch

    from keystone_tpu_torch.analysis import SpecDataset, validate_graph
    from keystone_tpu_torch.analysis.sharding import per_device_bytes
    from keystone_tpu_torch.parallel import specs_equal
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning.linear import LinearMapper
    from keystone_tpu_torch.nodes.stats import LinearRectifier, RandomSignNode
    from keystone_tpu_torch.nodes.util import MaxClassifier
    from keystone_tpu_torch.telemetry import counter
    from keystone_tpu_torch.workflow.graph import NodeId

    rng = np.random.default_rng(11)
    stages = [RandomSignNode(16, seed=4, device="cpu"), LinearRectifier(0.0),
              LinearMapper(torch.from_numpy(rng.normal(
                  size=(16, 10)).astype(np.float32)),
                  torch.from_numpy(rng.normal(size=10).astype(np.float32))),
              MaxClassifier()]
    X = rng.normal(size=(61, 16)).astype(np.float32)
    pipe = stages[0].to_pipeline()
    for st in stages[1:]:
        pipe = pipe >> st
    applied = pipe.apply(SpecDataset((16,), np.float32, count=61, name="x"))
    report = validate_graph(applied.graph, {}, level="full", mesh=mesh)
    static = {}
    for vid, sv in report.shardings.items():
        if isinstance(vid, NodeId):
            label = applied.graph.get_operator(vid).label
            spec = report.specs.get(vid)
            static[label] = (sv.leaf_specs()[0],
                             per_device_bytes(spec, sv, mesh))
    data = Dataset.from_numpy(X, mesh=mesh)
    rows = [["input", repr(data.spec),
             int(data.array.numel() * data.array.element_size())]]
    kinds = ("collectives.model.all_gather", "collectives.model.all_reduce")
    for st in stages:
        before = [counter(k).value for k in kinds]
        data = st.apply_batch(data)
        moved = [int(counter(k).value - b) for k, b in zip(kinds, before)]
        want, want_bytes = static[st.label]
        # the runtime spec against the static one, trailing Nones aside
        rows.append([st.label, repr(data.spec),
                     int(data.array.numel() * data.array.element_size()),
                     [repr(want), want_bytes], moved,
                     specs_equal(data.spec, want)])
    res["placement_rows"] = rows
    arr["placement_out"] = data.numpy()
    one = torch.from_numpy(X)
    for st in stages:
        one = st.batch_fn()(one) if hasattr(st, "batch_fn") else one
    arr["placement_one"] = one.numpy()


def model_job(rank, world, port, out_dir, res, arr):
    """The model axis on a ``(world/2, 2)`` mesh: `Dataset` tiles and
    their reshards, runtime placement against the static passes, the
    scaler, the three solvers, RandomPatchCifar staged and fused on
    JAX's draws, and the sharding planner's enforcement."""
    import torch

    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.learning import (
        BlockLeastSquaresEstimator,
        DenseLBFGSwithL2,
        LinearMapEstimator,
    )
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.parallel import (
        P,
        global_data_mesh,
        n_data_shards,
        n_model_shards,
    )
    from keystone_tpu_torch.telemetry import counter

    mesh = global_data_mesh(model_shards=2)
    res["mesh_axes"] = list(mesh.mesh_dim_names)
    res["shards"] = [n_data_shards(mesh), n_model_shards(mesh)]

    # tiles and their round trips
    X = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    ds = Dataset.from_numpy(X, mesh=mesh)
    res["tile"] = [list(ds.array.shape), ds.tiled, ds.width, ds.col_start,
                   repr(ds.spec)]
    arr["tile_rows"] = ds.array.numpy()
    arr["tile_numpy"] = ds.numpy()
    imgs = Dataset.from_numpy(np.zeros((16, 4, 4, 3), np.float32), mesh=mesh)
    odd = Dataset.from_numpy(np.ones((16, 7), np.float32), mesh=mesh)
    res["replicated_over_model"] = [imgs.tiled, repr(imgs.spec),
                                    odd.tiled, repr(odd.spec)]
    trips = {}
    for name, spec in (("data", P("data")), ("none", P()),
                       ("model", P(None, "model")),
                       ("data_model", P("data", "model"))):
        moved = ds.reshard(spec)
        trips[name] = [repr(moved.spec), list(moved.array.shape)]
        arr[f"reshard_{name}"] = moved.numpy()
        arr[f"reshard_{name}_back"] = moved.reshard(P("data", "model")).numpy()
    res["reshard"] = trips
    res["reshard_identity"] = ds.reshard(P("data", "model")) is ds
    # the card's transport under gloo (an all-reduce of a zeroed buffer,
    # gloo having no all-gather of a card's tensors) gives the same bits
    from keystone_tpu_torch.parallel import collectives

    direct = [collectives.all_gather_columns(ds.array, mesh),
              collectives.all_gather_rows(ds.array, mesh)]
    real = collectives._gloo_on_card
    collectives._gloo_on_card = lambda t: True
    try:
        summed = [collectives.all_gather_columns(ds.array, mesh),
                  collectives.all_gather_rows(ds.array, mesh)]
    finally:
        collectives._gloo_on_card = real
    res["card_transport_equal"] = all(
        torch.equal(a, b) for a, b in zip(direct, summed))

    _placement_chain(mesh, res, arr)

    # JAX's reconciliation of a trace: the static per-device bytes the
    # executor embeds against one rank's observed bytes of each node
    from keystone_tpu_torch.analysis.reconcile import reconcile_trace
    from keystone_tpu_torch.telemetry import trace_run
    from keystone_tpu_torch.workflow import Transformer

    from keystone_tpu_torch.parallel import use_mesh

    path = os.path.join(out_dir, f"trace-{rank}.json")
    src = Dataset.from_numpy(np.ones((64, 16), np.float32), mesh=mesh)
    with trace_run(path), use_mesh(mesh):
        traced = Transformer.from_function(
            lambda x: x * 2.0).to_pipeline()(src).get()
    rec = reconcile_trace(json.load(open(path)))
    res["trace_rows"] = [
        [r["label"], r["static_per_device_bytes"], r["observed_bytes"],
         r["spec"]] for r in rec["rows"]
        if r.get("static_per_device_bytes") and r["observed_bytes"]]
    res["trace_shard_bytes"] = int(traced.array.numel()
                                   * traced.array.element_size())
    res["trace_peaks"] = [rec["static_per_device_peak_bytes"],
                          rec["static_peak_bytes"]]

    # the scaler on a tile, at a count the data shards do not divide
    rng = np.random.default_rng(5)
    Xp = rng.normal(size=(1001, 6)).astype(np.float32)
    Yp = (Xp @ rng.normal(size=(6, 3)) + 0.1 * rng.normal(size=(1001, 3))
          ).astype(np.float32)
    dX = Dataset.from_numpy(Xp, mesh=mesh)
    dY = Dataset.from_numpy(Yp, mesh=mesh)
    scaler = StandardScaler().fit(dX)
    arr["pad_mean"], arr["pad_std"] = scaler.mean.numpy(), scaler.std.numpy()
    scaled = scaler.apply_batch(dX)
    res["pad_scaled_tiled"] = scaled.tiled
    arr["pad_scaled"] = scaled.numpy()

    def fit(name, est, X, Y):
        before = counter("collectives.model.all_gather").value
        m = est.fit(Dataset.from_numpy(X, mesh=mesh),
                    Dataset.from_numpy(Y, mesh=mesh))
        res[f"{name}_model_gathers"] = (
            counter("collectives.model.all_gather").value - before)
        arr[f"{name}_W"], arr[f"{name}_b"] = m.W.numpy(), m.b.numpy()

    fit("pad_exact", LinearMapEstimator(lam=0.1), Xp, Yp)
    fit("pad_bcd", BlockLeastSquaresEstimator(2, 3, lam=0.1), Xp, Yp)
    fit("pad_lbfgs", DenseLBFGSwithL2(lam=0.5, num_iters=15), Xp, Yp)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(96, 6)).astype(np.float32)
    fit("exact", LinearMapEstimator(lam=0.0), X,
        X @ rng.normal(size=(6, 3)).astype(np.float32))
    rng = np.random.default_rng(7)
    X = rng.normal(size=(96, 24)).astype(np.float32)
    W = rng.normal(size=(24, 3)).astype(np.float32)
    fit("bcd", BlockLeastSquaresEstimator(block_size=8, num_iter=4, lam=0.1),
        X, X @ W + 0.01 * rng.normal(size=(96, 3)).astype(np.float32))
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    fit("lbfgs", DenseLBFGSwithL2(lam=0.5, num_iters=15), X,
        X @ rng.normal(size=(16, 2)).astype(np.float32))

    _model_cifar(mesh, out_dir, res, arr)
    _planner_enforces(mesh, res, arr)


def _model_cifar(mesh, out_dir, res, arr):
    """RandomPatchCifar at the small width on the mesh: filters from
    JAX's draws, the staged pipeline, `fused_fit`, `run_staged` and
    `run_fused` (the port's own draws)."""
    import torch

    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.evaluation.multiclass import MulticlassMetrics
    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.pipelines import random_patch_cifar as rpc
    from keystone_tpu_torch.telemetry import counter
    from keystone_tpu_torch.workflow import PipelineEnv

    config = rpc.RandomPatchCifarConfig(**CIFAR_CFG)
    train, test = synthetic_cifar(*CIFAR_N, noise=1.2, confusion=0.6,
                                  device="cpu", mesh=mesh)
    draws = np.load(os.path.join(out_dir, "..", "cifar-reference",
                                 "draws.npz"))
    filters, whitener = rpc.learn_filters_from_indices(
        train.data, *(torch.from_numpy(draws[k]) for k in
                      ("img_idx", "patch_idx", "filter_idx")),
        config.patch_size, config.patch_steps)
    arr["filters"] = filters.numpy()
    evaluator = MulticlassClassifierEvaluator(10)
    PipelineEnv.reset()
    before = counter("collectives.model.all_gather").value
    predictor = rpc.build_pipeline(train, config, learned=(filters, whitener))
    preds = predictor(test.data).get()
    res["staged_pred_spec"] = repr(preds.spec)
    arr["staged_preds"] = preds.numpy()
    res["staged_test_accuracy"] = evaluator(predictor(test.data),
                                            test.labels).accuracy
    res["staged_model_gathers"] = (
        counter("collectives.model.all_gather").value - before)
    model = predictor.fitted(1)
    arr["staged_W"], arr["staged_b"] = model.W.numpy(), model.b.numpy()
    W, b, _, conf_test, _ = rpc.fused_fit(train, test, filters, whitener,
                                          config)
    arr["fused_W"], arr["fused_b"] = W.numpy(), b.numpy()
    res["fused_test_accuracy"] = MulticlassMetrics(
        conf_test.numpy().astype(np.float64)).accuracy
    _, metrics = rpc.run_staged(train, config, evaluator)
    res["run_staged_total"] = metrics.total
    fused = rpc.run_fused(train, test, config)
    res["run_fused_test_accuracy"] = fused["test_accuracy"]
    arr["run_fused_W"] = fused["W"].numpy()
    PipelineEnv.reset()


def planner_predictor(dim=64, classes=4):
    """JAX's `tests/test_planner.py::_predictor`: ``RandomSignNode >>
    PaddedFFT >> LinearRectifier`` into BCD (block 32, one epoch) and
    `MaxClassifier`."""
    from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.stats import (
        LinearRectifier,
        PaddedFFT,
        RandomSignNode,
    )
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromInt,
        MaxClassifier,
    )

    featurizer = (RandomSignNode(dim, device="cpu").to_pipeline()
                  >> PaddedFFT() >> LinearRectifier(0.0))

    def build(data, labels_ds):
        labels = ClassLabelIndicatorsFromInt(classes)(labels_ds)
        return featurizer.and_then(
            BlockLeastSquaresEstimator(32, num_iter=1, lam=1e-3),
            data, labels) >> MaxClassifier()

    return build


def planner_data(n, dim=64, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim).astype(np.float32),
            rng.randint(0, classes, size=n).astype(np.int32))


def _planner_enforces(mesh, res, arr):
    """JAX's `test_planner_enforces_and_outputs_match_serial_unfused` on
    the mesh: planner on against the serial unfused plan with it off, at
    64 rows and at 43 (which the data shards do not divide)."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.workflow.env import config_override
    from keystone_tpu_torch.workflow.operators import DatasetOperator
    from keystone_tpu_torch.workflow.optimizer import DefaultOptimizer

    from keystone_tpu_torch.parallel import use_mesh
    from keystone_tpu_torch.telemetry import counter

    build = planner_predictor()
    for n in (64, 43):
        X, y = planner_data(n)

        def run(optimizer, planner_on):
            PipelineEnv.reset()
            if optimizer is not None:
                PipelineEnv.get().set_optimizer(optimizer)
            with config_override(sharding_planner=planner_on), \
                    use_mesh(mesh):
                data = Dataset.from_numpy(X, mesh=mesh)
                labels = Dataset.from_numpy(y, mesh=mesh)
                applied = build(data, labels)(data)
                out = applied.get().numpy()
                graph = applied.executor.optimized_graph
            PipelineEnv.reset()
            return out, graph

        before = counter("planner.plans_enforced").value
        planned, g = run(None, True)
        res[f"planner_{n}_enforced"] = (
            counter("planner.plans_enforced").value - before)
        serial, _ = run(DefaultOptimizer(fuse=False, sharding_planner=False),
                        False)
        arr[f"planner_{n}"], arr[f"serial_{n}"] = planned, serial
        ops = [g.get_operator(v) for v in g.operators]
        res[f"planner_{n}_tagged"] = [
            repr(op.planned_out_spec) for op in ops
            if getattr(op, "planned_out_spec", None) is not None]
        res[f"planner_{n}_reseeded"] = [
            repr(op.dataset.spec) for op in ops
            if isinstance(op, DatasetOperator)
            and hasattr(op.dataset, "spec")]

    # the kill switch: the plan without the planner, bit for bit
    X, y = planner_data(64)

    def optimize(planner_on, optimizer=None):
        PipelineEnv.reset()
        if optimizer is not None:
            PipelineEnv.get().set_optimizer(optimizer)
        with config_override(sharding_planner=planner_on), use_mesh(mesh):
            data = Dataset.from_numpy(X, mesh=mesh)
            labels = Dataset.from_numpy(y, mesh=mesh)
            g = build(data, labels)(data).executor.optimized_graph
        PipelineEnv.reset()
        shape = [[v.id, type(g.get_operator(v)).__name__,
                  [getattr(d, "id", -1) for d in g.get_dependencies(v)],
                  repr(getattr(g.get_operator(v), "planned_out_spec", None))]
                 for v in sorted(g.operators, key=lambda v: v.id)]
        own = any(g.get_operator(v).dataset is data for v in g.operators
                  if isinstance(g.get_operator(v), DatasetOperator))
        return shape, own

    res["kill_switch"] = optimize(False)
    res["kill_switch_ctor"] = optimize(
        True, DefaultOptimizer(sharding_planner=False))
    res["planner_on"] = optimize(True)


def estimator_data():
    """Seeded inputs of `estimators_job`, made alike by every rank and by
    the parent: 197 rows (a count 2 and 4 ranks pad), descriptor
    matrices of ragged counts, multi-label ±1 indicators, a 9-row BWLS
    set (four ranks leave the last one no valid row), augmented ids and
    scores, mAP scores with ties."""
    rng = np.random.default_rng(11)
    n, d = 197, 12
    centers = rng.normal(scale=3.0, size=(4, d)).astype(np.float32)
    which = rng.integers(0, 4, size=n)
    X = (centers[which] + rng.normal(size=(n, d))).astype(np.float32)
    Y = -np.ones((n, 4), np.float32)
    Y[np.arange(n), which] = 1.0
    Y[np.arange(0, n, 7), (which[::7] + 1) % 4] = 1.0   # multi-label rows
    Xt = (centers[rng.integers(0, 4, size=61)]
          + rng.normal(size=(61, d))).astype(np.float32)
    desc = [rng.normal(size=(int(rng.integers(5, 9)), 6)).astype(np.float32)
            for _ in range(37)]
    Xs = rng.normal(size=(9, 6)).astype(np.float32)
    Ys = -np.ones((9, 2), np.float32)
    Ys[np.arange(9), np.arange(9) % 2] = 1.0
    ids = np.repeat(np.arange(41), 5)[:197]
    labels = rng.integers(0, 4, size=41)[ids]
    scores = rng.normal(size=(197, 4)).astype(np.float32)
    scores[::9] = 0.5                                       # ties
    actual_lists = [sorted({int(which[i]), int((which[i] + i) % 4)})
                    for i in range(n)]
    return dict(X=X, Y=Y, Xt=Xt, desc=desc, Xs=Xs, Ys=Ys, ids=ids,
                labels=labels, scores=scores, actual_lists=actual_lists)


#: the estimators `estimators_job` fits, by name; each takes the data
#: and returns its arrays (the parent runs the same on one process)
KRR_CFG = dict(gamma=0.05, lam=0.5, block_size=32, num_epochs=2, seed=3)


def fit_estimators(D, place, host, gather):
    """Every estimator and evaluator of the data axis on ``D``:
    ``place(x)`` makes a `Dataset` of a whole array, ``host(items)`` a
    `HostDataset` of whole items, ``gather(ds)`` the whole rows of a
    dataset. The same calls on one process (identity placement) give
    the reference. Returns name → array."""
    import torch

    from keystone_tpu_torch.evaluation import (
        AugmentedExamplesEvaluator,
        MeanAveragePrecisionEvaluator,
    )
    from keystone_tpu_torch.nodes.images.fisher_vector import (
        GMMFisherVectorEstimator,
    )
    from keystone_tpu_torch.nodes.learning import (
        BlockWeightedLeastSquaresEstimator,
        ColumnPCAEstimator,
        DistributedPCAEstimator,
        GaussianMixtureModelEstimator,
        KernelRidgeRegression,
        KMeansPlusPlusEstimator,
        PCAEstimator,
        PerClassWeightedLeastSquares,
    )

    out = {}
    X, Y = place(D["X"]), place(D["Y"])
    krr = KernelRidgeRegression(**KRR_CFG).fit(X, Y)
    out["krr_alpha"] = gather(X.with_data(krr.alpha))
    out["krr_pred"] = gather(krr.apply_batch(place(D["Xt"])))
    krr4 = KernelRidgeRegression(0.05, 0.5, 64, 1, seed=4)
    m4 = krr4.fit(X, Y)
    m4.block_size = 50                        # apply blocks ≠ fit blocks
    out["krr_pred_b50"] = gather(m4.apply_batch(place(D["Xt"])))
    out["pca_local"] = PCAEstimator(4, sample_rows=150).fit(X).components
    out["pca_tsqr"] = DistributedPCAEstimator(4).fit(X).components
    out["pca_tsqr_desc"] = DistributedPCAEstimator(3).fit(
        host(D["desc"])).components
    col = ColumnPCAEstimator(3)
    col.optimize(host(D["desc"]).sample_per_shard(3), 10)
    out["column_pca_local"] = np.array(col.chosen == "local")
    out["kmeans"] = KMeansPlusPlusEstimator(4, 10, seed=1).fit(X).centers
    g = GaussianMixtureModelEstimator(3, num_iters=5, max_rows=150).fit(X)
    out["gmm_means"], out["gmm_vars"], out["gmm_wts"] = (
        g.means, g.variances, g.weights)
    fv = GMMFisherVectorEstimator(3, num_iters=4).fit(host(D["desc"]))
    out["fv_means"] = fv.gmm.means
    bw = BlockWeightedLeastSquaresEstimator(4, 2, 0.1).fit(X, Y)
    out["bwls_W"], out["bwls_b"] = bw.W, bw.b
    small = BlockWeightedLeastSquaresEstimator(3, 2, 0.5, 0.3).fit(
        place(D["Xs"]), place(D["Ys"]))
    out["bwls_small_W"], out["bwls_small_b"] = small.W, small.b
    pc = PerClassWeightedLeastSquares(0.1).fit(X, Y)
    out["perclass_W"], out["perclass_b"] = pc.W, pc.b
    for agg in ("mean", "max", "borda"):
        m = AugmentedExamplesEvaluator(4, agg)(
            place(D["ids"]), place(D["scores"]), place(D["labels"]))
        out[f"aug_{agg}"] = m.confusion
    out["map"] = MeanAveragePrecisionEvaluator(4)(
        place(D["scores"]), D["actual_lists"])
    out["map_host"] = MeanAveragePrecisionEvaluator(4)(
        place(D["scores"]), host(D["actual_lists"]))
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def estimators_job(rank, world, port, out_dir, res, arr):
    """The data-axis estimators and evaluators on this world's ranks
    (`fit_estimators`), the row gathers, and naive Bayes and the binary
    evaluator on the same placed rows (the text side's, fitted and
    scored across ranks since the guard let them through)."""
    import torch

    from keystone_tpu_torch.data.dataset import Dataset, HostDataset
    from keystone_tpu_torch.evaluation import BinaryClassifierEvaluator
    from keystone_tpu_torch.nodes.learning import NaiveBayesEstimator
    from keystone_tpu_torch.parallel import (
        collect_rows,
        gather_rows,
        global_data_mesh,
    )
    from keystone_tpu_torch.telemetry import counter

    mesh = global_data_mesh()
    D = estimator_data()
    before = {k: counter(f"collectives.data.{k}").value
              for k in ("all_gather", "all_reduce")}
    ds = Dataset.from_numpy(D["X"], mesh=mesh)
    ids = np.random.default_rng(5).integers(0, 197, size=40)
    ids[-3:] = ids[:3]                                       # repeats
    arr["gather_rows"] = gather_rows(ds.array, ids, mesh).numpy()
    # no mesh: this process's rows, though a group (and so a current
    # mesh) exists
    arr["gather_rows_no_mesh"] = gather_rows(torch.from_numpy(D["X"]), ids,
                                             None).numpy()
    per = -(-len(D["desc"]) // world)
    local = np.concatenate([np.zeros((0, 6), np.float32)]
                           + D["desc"][rank * per:(rank + 1) * per])
    arr["collect_rows"] = collect_rows(torch.from_numpy(local), mesh,
                                       max_rows=100).numpy()
    res["row_gathers"] = {k: counter(f"collectives.data.{k}").value - v
                          for k, v in before.items()}
    arr.update(fit_estimators(
        D, lambda x: Dataset.from_numpy(x, mesh=mesh),
        lambda items: HostDataset.on_mesh(items, mesh, device="cpu"),
        lambda d: d.numpy()))
    for name, fn in (
            ("naive_bayes", lambda: NaiveBayesEstimator(4).fit(
                Dataset.from_numpy(np.abs(D["X"]), mesh=mesh),
                Dataset.from_numpy(D["ids"].astype(np.int32) % 4,
                                   mesh=mesh))),
            ("binary", lambda: BinaryClassifierEvaluator()(
                Dataset.from_numpy(D["X"][:, 0] > 0, mesh=mesh),
                Dataset.from_numpy(D["X"][:, 1] > 0, mesh=mesh)))):
        try:
            out = fn()
            res[f"guard_{name}"] = ""
        except NotImplementedError as e:
            res[f"guard_{name}"] = str(e)
            continue
        if name == "naive_bayes":
            arr["nb_log_priors"] = out.log_priors.numpy()
            arr["nb_log_cond"] = out.log_cond.numpy()
        else:
            arr["binary_table"] = np.array([out.tp, out.fp, out.tn, out.fn])


#: the pipelines of `estimator_pipelines_job`, at the CPU tests' sizes
KERNEL_CIFAR_CFG = dict(num_filters=16, microbatch=32, sample_patches=5000,
                        kernel_block=64, gamma=2e-3, lam=10.0,
                        kernel_epochs=1)
KERNEL_CIFAR_N = (300, 100)
AUG_KERNEL_CFG = dict(num_filters=8, microbatch=64, sample_patches=2000,
                      kernel_block=64, synth_train=61, synth_test=21,
                      lam=1.0, seed=2)
VOC_CFG = dict(n_synth=30, num_classes=4, gmm_k=4, pca_dims=16)
IMAGENET_CFG = dict(n_synth=40, num_classes=5, gmm_k=4, pca_dims=16)


def _without_argmax(predictor):
    """``predictor`` with its sink moved off the final MaxClassifier."""
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    g = predictor.graph
    argmax = g.get_sink_dependency(predictor.sink)
    g = g.set_sink_dependency(predictor.sink, g.get_dependencies(argmax)[0])
    return Pipeline(g, predictor.source, predictor.sink)


def estimator_pipelines_job(rank, world, port, out_dir, res, arr):
    """RandomPatchCifarKernel on JAX's filters (the parent writes them to
    ``estimator-pipelines-reference/jax.npz``) and on its own, the
    augmented pair, VOCSIFTFisher and ImageNetSiftLcsFV at small sizes
    on this world's ranks; world 1 is one process."""
    import torch

    from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener
    from keystone_tpu_torch.parallel import global_data_mesh
    from keystone_tpu_torch.pipelines import cifar_variants as cv
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as imagenet
    from keystone_tpu_torch.pipelines import voc_sift_fisher as voc
    from keystone_tpu_torch.workflow import PipelineEnv

    mesh = global_data_mesh()
    ref = np.load(os.path.join(out_dir, "..",
                               "estimator-pipelines-reference", "jax.npz"))
    config = cv.RandomPatchCifarKernelConfig(**KERNEL_CIFAR_CFG)
    train, test = synthetic_cifar(*KERNEL_CIFAR_N, noise=1.2, confusion=0.6,
                                  device="cpu", mesh=mesh)
    learned = (torch.from_numpy(ref["filters"]),
               ZCAWhitener(torch.from_numpy(ref["whitener"]),
                           torch.from_numpy(ref["means"])))
    PipelineEnv.reset()
    predictor = cv.build_random_patch_cifar_kernel(train, config, learned)
    arr["kernel_scores"] = _without_argmax(predictor)(test.data).get().numpy()
    PipelineEnv.reset()
    own = cv.run_random_patch_cifar_kernel(
        cv.RandomPatchCifarKernelConfig(
            **KERNEL_CIFAR_CFG, synth_train=KERNEL_CIFAR_N[0],
            synth_test=KERNEL_CIFAR_N[1]), "cpu")
    res["kernel_own_accuracy"] = own["test_accuracy"]
    arr["kernel_own_preds"] = own["predictor"](test.data).get().numpy()

    for name, run, config_cls in (
            ("aug_kernel", cv.run_random_patch_cifar_augmented_kernel,
             cv.RandomPatchCifarAugmentedKernelConfig),
            ("aug", cv.run_random_patch_cifar_augmented,
             cv.RandomPatchCifarAugmentedConfig)):
        PipelineEnv.reset()
        cfg = {k: v for k, v in AUG_KERNEL_CFG.items()
               if k in config_cls.__dataclass_fields__}
        aug = run(config_cls(**cfg), "cpu")
        res[f"{name}_accuracy"] = aug["test_accuracy"]
        res[f"{name}_train_error"] = aug["train_error"]
        arr[f"{name}_confusion"] = np.asarray(aug["test_confusion"])

    PipelineEnv.reset()
    out = voc.run(voc.VOCSIFTFisherConfig(**VOC_CFG), device="cpu")
    res["voc_map"] = out["map"]
    arr["voc_aps"] = np.asarray(out["aps"])
    arr["voc_scores"] = out["scores"].numpy()
    model = out["model"]
    arr["voc_pca"] = model.pca.fitted().components.numpy()
    arr["voc_gmm_means"] = model.fisher.fitted().gmm.means.numpy()
    arr["voc_W"] = model.predictor.fitted().W.numpy()

    PipelineEnv.reset()
    out = imagenet.run(imagenet.ImageNetSiftLcsFVConfig(**IMAGENET_CFG),
                       device="cpu")
    res["imagenet_accuracy"] = out["test_accuracy"]


#: the text side's corpus: 197 documents of 4 classes (a count 2 and 4
#: ranks pad), the pipelines' synthetic corpora at 197 documents, and
#: the dense sets of the estimators it adds
TEXT_N, TEXT_CLASSES, TEXT_FEATURES = 197, 4, 300
TEXT_LAM, TEXT_ITERS = 0.1, 15


def text_axis_data():
    """Seeded inputs of `text_axis_job`, made alike by every rank and by
    the parent: the corpus (the JAX package's `synthetic_corpus`, copied
    bit for bit), ±1 indicators of its labels' parity, three-class rows
    for LDA, rows for ZCA and the approximate PCA, a 23 × 40 dual
    problem, anchor and apply rows for the kernel generator, and boolean
    predictions against actuals."""
    from keystone_tpu_torch.pipelines.text_pipelines import synthetic_corpus

    labels, docs = synthetic_corpus(TEXT_N, TEXT_CLASSES, vocab_size=120,
                                    doc_len=30, seed=5)
    rng = np.random.default_rng(17)
    y = np.asarray(labels.items, np.int64)
    Yi = -np.ones((TEXT_N, 2), np.float32)
    Yi[np.arange(TEXT_N), y % 2] = 1.0
    centers = rng.normal(scale=2.0, size=(3, 8))
    y3 = rng.integers(0, 3, size=TEXT_N)
    X3 = (centers[y3] + rng.normal(size=(TEXT_N, 8))).astype(np.float32)
    Z = (rng.normal(size=(TEXT_N, 6)) @ rng.normal(size=(6, 6))).astype(
        np.float32)
    L = rng.normal(size=(23, 40)).astype(np.float32)
    LY = rng.normal(size=(23, 2)).astype(np.float32)
    A = rng.normal(size=(37, 5)).astype(np.float32)
    B = rng.normal(size=(61, 5)).astype(np.float32)
    pred = rng.random(TEXT_N) < 0.6
    actual = rng.random(TEXT_N) < 0.5
    return dict(docs=docs.items, labels=labels.items, Yi=Yi, X3=X3,
                y3=y3.astype(np.int32), Z=Z, L=L, LY=LY, A=A, B=B,
                pred=pred, actual=actual)


def _key(f) -> str:
    """A vocabulary key (a word or an n-gram tuple) as a string."""
    return " ".join(f) if isinstance(f, tuple) else str(f)


def fit_text_side(D, mesh, res, arr):
    """Every text-side estimator, the sparse datasets, the dense fits
    this slice marks, the binary evaluator and the three text pipelines
    on ``mesh``'s ranks (a mesh of one data shard: one process). The
    whole-corpus values land in ``res``, the arrays in ``arr``."""
    import torch

    from keystone_tpu_torch.data.dataset import Dataset, HostDataset
    from keystone_tpu_torch.data.sparse import PaddedSparseDataset
    from keystone_tpu_torch.evaluation import BinaryClassifierEvaluator
    from keystone_tpu_torch.nodes.learning import (
        ApproximatePCAEstimator,
        GaussianKernelGenerator,
        LeastSquaresEstimator,
        LinearDiscriminantAnalysis,
        LocalLeastSquaresEstimator,
        LogisticRegressionEstimator,
        NaiveBayesEstimator,
        SparseLBFGSwithL2,
        ZCAWhitenerEstimator,
    )
    from keystone_tpu_torch.nodes.nlp import (
        LowerCase,
        NGramsCounts,
        NGramsFeaturizer,
        PackedStupidBackoffEstimator,
        StupidBackoffEstimator,
        Tokenizer,
        Trim,
        WordFrequencyEncoder,
    )
    from keystone_tpu_torch.nodes.util.sparse_features import (
        AllSparseFeatures,
        CommonSparseFeatures,
    )
    from keystone_tpu_torch.pipelines import text_pipelines as tp
    from keystone_tpu_torch.workflow import PipelineEnv

    def place(x):
        return Dataset.from_numpy(x, mesh=mesh)

    def t(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    docs = HostDataset.on_mesh(D["docs"], mesh, device="cpu")
    labels = HostDataset.on_mesh(D["labels"], mesh)
    pairs = tp.text_featurizer()(docs).get()
    vec = CommonSparseFeatures(TEXT_FEATURES).fit(pairs)
    res["common_vocab"] = sorted([_key(f), i] for f, i in vec.vocab.items())
    res["all_vocab"] = sorted([_key(f), i] for f, i in
                              AllSparseFeatures().fit(pairs).vocab.items())
    X = vec.apply_batch(pairs)
    res["csr_placement"] = [X.count, X.total, X.per_shard_count,
                            X.first_row, X.mesh is not None]
    whole = X.gather()
    arr["csr_data"], arr["csr_indices"], arr["csr_indptr"] = (
        whole.data, whole.indices, whole.indptr)
    sample = X.sample_per_shard(10)
    arr["csr_sample"] = sample.matrix.toarray()
    arr["csr_dense"] = X.densify().numpy()
    res["sparsity"] = X.sparsity
    padded = PaddedSparseDataset.from_csr(X, device="cpu")
    padded_whole = PaddedSparseDataset.from_csr(whole, device="cpu",
                                                mesh=mesh)
    res["padded"] = [padded.width, padded.total, padded.count,
                     padded_whole.width, padded_whole.total,
                     bool(torch.equal(padded.idx, padded_whole.idx))]

    nb = NaiveBayesEstimator(TEXT_CLASSES).fit(X, labels)
    arr["nb_log_priors"], arr["nb_log_cond"] = t(nb.log_priors), t(
        nb.log_cond)
    arr["nb_scores"] = nb.apply_batch(X).numpy()
    y_placed = place(np.asarray(D["labels"], np.int32))
    nb_dense = NaiveBayesEstimator(TEXT_CLASSES).fit(X.densify(), y_placed)
    arr["nb_dense_log_cond"] = t(nb_dense.log_cond)

    lr = LogisticRegressionEstimator(TEXT_CLASSES, lam=1e-3,
                                     num_iters=TEXT_ITERS)
    lr_model = lr.fit(X, y_placed)
    arr["lr_W"] = t(lr_model.W)
    arr["lr_history"] = np.asarray(lr.loss_history, np.float64)
    arr["lr_preds"] = lr_model.apply_batch(X).numpy()

    Y = place(D["Yi"])
    routed = SparseLBFGSwithL2(TEXT_LAM, TEXT_ITERS)
    routed.fit(X, Y)
    res["slbfgs_route"] = routed.route
    for name, data in (("slbfgs", X), ("slbfgs_padded", padded)):
        est = SparseLBFGSwithL2(TEXT_LAM, TEXT_ITERS, method="iterative")
        m = est.fit(data, Y)
        arr[f"{name}_W"], arr[f"{name}_b"] = t(m.W), t(m.b)
        arr[f"{name}_history"] = t(est.loss_history)
    dense_est = SparseLBFGSwithL2(TEXT_LAM, TEXT_ITERS)
    m = dense_est.fit(X.densify(), Y)
    res["slbfgs_dense_route"] = dense_est.route
    arr["slbfgs_dense_W"], arr["slbfgs_dense_b"] = t(m.W), t(m.b)

    lse = LeastSquaresEstimator(lam=TEXT_LAM, num_iters=TEXT_ITERS)
    lse_model = lse.fit(X, Y)
    res["lse_chosen"] = lse.chosen
    res["lse_chips"] = lse._measure(X, Y, X.per_shard_count).num_chips
    arr["lse_pred"] = lse_model.apply_batch(X).numpy()

    arr["lda"] = t(LinearDiscriminantAnalysis(2).fit(
        place(D["X3"]), place(D["y3"])).components)
    zca = ZCAWhitenerEstimator(0.1).fit(place(D["Z"]))
    arr["zca_whitener"], arr["zca_means"] = t(zca.whitener), t(zca.means)
    arr["approx_pca"] = t(ApproximatePCAEstimator(3, seed=2).fit(
        place(D["Z"])).components)
    arr["local_ls"] = t(LocalLeastSquaresEstimator(0.5).fit(
        place(D["L"]), place(D["LY"])).W)
    gen = GaussianKernelGenerator(0.3).fit(place(D["A"]))
    arr["kgen_anchors"] = t(gen.anchors)
    arr["kgen_out"] = gen.apply_batch(place(D["B"])).numpy()

    ev = BinaryClassifierEvaluator()
    for name, (p, a) in (
            ("binary", (place(D["pred"]), D["actual"])),
            ("binary_host", (HostDataset.on_mesh(list(D["pred"]), mesh),
                             HostDataset.on_mesh(list(D["actual"]), mesh)))):
        m = ev(p, a)
        arr[name] = np.array([m.tp, m.fp, m.tn, m.fn])

    tokens = (Trim().to_pipeline() >> LowerCase() >> Tokenizer())(
        docs).get()
    enc = WordFrequencyEncoder().fit(tokens)
    res["wfe_order"] = sorted(enc.vocab, key=enc.vocab.get)
    res["wfe_counts"] = sorted(enc.word_counts.items())
    trigrams = NGramsFeaturizer([3]).apply_batch(tokens)
    sb = StupidBackoffEstimator().fit(
        NGramsCounts("no-add").apply_batch(trigrams))
    res["backoff_counts"] = sorted([_key(k), v]
                                   for k, v in sb.ngram_counts.items())
    res["backoff_unigrams"] = sorted(sb.unigram_counts.items())
    packed = PackedStupidBackoffEstimator().fit(tokens)
    res["packed_vocab"] = list(packed.vocab)
    arr["packed_keys"], arr["packed_counts"] = packed.keys, packed.counts
    arr["packed_unigram"] = packed.unigram

    PipelineEnv.reset()
    news = tp.run_newsgroups(tp.NewsgroupsConfig(n_synth=TEXT_N), "cpu",
                             mesh)
    res["news"] = [news["test_accuracy"], news["train_error"]]
    nb = news["model"].classifier.fitted()
    arr["news_log_cond"] = t(nb.log_cond)
    arr["news_log_priors"] = t(nb.log_priors)
    PipelineEnv.reset()
    amazon = tp.run_amazon(tp.AmazonReviewsConfig(n_synth=TEXT_N), "cpu",
                           mesh)
    res["amazon"] = [amazon["test_accuracy"], amazon["f1"]]
    arr["amazon_W"] = t(amazon["model"].classifier.fitted().W)
    res["amazon_vocab"] = sorted(
        _key(f) for f in amazon["model"].vocabulary.fitted().vocab)
    PipelineEnv.reset()
    backoff = tp.run_stupid_backoff(tp.StupidBackoffConfig(n_synth=TEXT_N),
                                    "cpu", mesh)
    res["backoff"] = [backoff["vocab"], backoff["num_trigrams"],
                      backoff["mean_log_score"]]


def text_axis_job(rank, world, port, out_dir, res, arr):
    """The text side of the data axis on this world's ranks
    (`fit_text_side`) and the collectives it ran, by kind."""
    from keystone_tpu_torch.parallel import global_data_mesh
    from keystone_tpu_torch.telemetry import counter

    kinds = ("all_gather_object", "all_reduce", "all_gather")
    before = {k: counter(f"collectives.data.{k}").value for k in kinds}
    fit_text_side(text_axis_data(), global_data_mesh(), res, arr)
    res["collectives"] = {k: counter(f"collectives.data.{k}").value - v
                          for k, v in before.items()}


JOBS = {"collectives": collectives_job, "cifar": cifar_job,
        "model": model_job, "estimators": estimators_job,
        "estimator_pipelines": estimator_pipelines_job,
        "text_axis": text_axis_job}


def main(argv) -> int:
    job, rank, world, port, out_dir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    import torch

    from keystone_tpu_torch.parallel import barrier, init_multihost

    torch.manual_seed(0)
    init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu",
                   timeout=GROUP_TIMEOUT_S)
    res, arr = {}, {}
    JOBS[job](rank, world, port, out_dir, res, arr)
    barrier()
    np.savez(os.path.join(out_dir, f"{job}-{rank}.npz"), **arr)
    with open(os.path.join(out_dir, f"{job}-{rank}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
