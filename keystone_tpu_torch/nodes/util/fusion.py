"""Stage fusion + microbatching.

Counterpart of `keystone_tpu/nodes/util/fusion.py`: `FusedBatchTransformer`
(`:320-`) runs a chain of stages over microbatches of rows, so only one
microbatch's intermediates are alive at a time, and `_peephole`
(`:141-176`) merges Convolver >> SymmetricRectifier >> Pooler(sum) into
the fused conv+rectify+pool kernel and a bare SymmetricRectifier >>
Pooler(sum) into the rectify+pool kernel (`ops/kernels.py`). The
`planned_kernel` tag (`:371-394`) swaps a sub-trail of the peepholed
stages for one chain kernel launch (`ops/chain_kernels.py`; the swap is
`_kernel_swap`, `:460-477`, applied `:538-555`). Where that launch is
the last stage, the transformer allocates its result once and each
microbatch's launch writes its own rows of it. `_GatherConcatStage`
(`:274-316`) is a `Pipeline.gather` fan-out and its `VectorCombiner`
collapsed into one stage, the form the optimizer's gather pass
(`workflow/fusion_rule.py::NodeFusionRule._fuse_gathers`) gives them; as
the last stage it too writes each microbatch's branch outputs into their
columns of the rows allocated once. A `FusedBatchTransformer` is itself
a fusable stage (`:328-330`): inside a larger fused chain it is one
opaque stage keyed ``("FusedChain", ...)``, which no chain kernel
absorbs, while its own peephole and planned kernel still run inside it.
`MegafusedBatchTransformer` (`:745-804`) is the whole-plan chain that
`workflow/fusion_rule.py::MegafusionRule` builds: its rows are padded to
a rung and its chunk loop runs as one CUDA graph replay a call
(`utils/graphs.py`), captured at its second use or at warm-up (the first
use runs the padded loop eagerly); on the CPU the same padded loop runs
eagerly over the plain versions. Host streams run a fused chain's
chunks the same way (`FusedBatchTransformer.run_rung`), so each chain
keeps one cache of graphs. A fused chain is
``chunkable`` when every stage is (`:292, 405-410`). The JAX package's
program caching, planned precision and sharding tags have no counterpart
here.

Telemetry (`:535-555, 784-791`): each microbatch a ``chunk`` span, each
padded loop a ``megafused_program`` span and one count in
``megafusion.programs`` and its trips in ``megafusion.scan_trips``; a
capture counts in ``megafusion.graph_captures`` and as a cold compile
(`telemetry/compile_events.py`), a replay in ``megafusion.graph_replays``.
Counts go through `tally`, so what a capture records is added at every
replay.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence, Tuple

import torch

from ...ops.chain_kernels import build_chain_fn, lowerability
from ...ops.kernels import (
    conv_rectify_pool,
    hwio_to_cmajor,
    rectify_pool,
)
from ...telemetry.compile_events import record_compile
from ...telemetry.metrics import counter, tallied, tally
from ...telemetry.spans import current_tracer, span
from ...workflow.pipeline import Transformer

_PROGRAMS = counter("megafusion.programs")
_SCAN_TRIPS = counter("megafusion.scan_trips")
_GRAPH_CAPTURES = counter("megafusion.graph_captures")
_GRAPH_REPLAYS = counter("megafusion.graph_replays")


class _RectifyPoolStage(Transformer):
    """SymmetricRectifier >> Pooler(sum) through the rectify+pool kernel."""

    fusable = True

    def __init__(self, alpha: float, max_val: float, pool: int, stride: int):
        self.alpha = alpha
        self.max_val = max_val
        self.pool = pool
        self.stride = stride

    def batch_fn(self):
        return lambda x: rectify_pool(x, self.alpha, self.max_val, self.pool,
                                      self.stride)

    def fuse(self):
        return ("RectifyPool", self.alpha, self.max_val, self.pool,
                self.stride), ()


class _ConvRectifyPoolStage(Transformer):
    """Convolver >> SymmetricRectifier >> Pooler(sum) through the fused
    conv+rectify+pool kernel: the conv output and the channel-doubled
    activations never reach device memory."""

    fusable = True

    def __init__(self, conv, alpha: float, max_val: float, pool: int,
                 stride: int):
        self.alpha = alpha
        self.max_val = max_val
        self.pool = pool
        self.stride = stride
        self.patch = conv.patch
        self.normalize = conv.normalize_patches
        self.g_cmajor = hwio_to_cmajor(conv.kernel).contiguous()
        self.colsum = conv.colsum.contiguous()
        self.bias = conv.bias.contiguous()

    def batch_fn(self):
        return lambda x: conv_rectify_pool(
            x.contiguous(), self.g_cmajor, self.colsum, self.bias,
            self.alpha, self.max_val, self.pool, self.stride, self.normalize,
            self.patch)

    def fuse(self):
        return (("ConvRectifyPool", self.alpha, self.max_val, self.pool,
                 self.stride, self.patch, self.normalize),
                (self.g_cmajor, self.colsum, self.bias))


def _run(fns, xb):
    for fn in fns:
        xb = fn(xb)
    return xb


class _GatherConcatStage(Transformer):
    """N branch transformers over one input, their outputs concatenated
    along the last axis in branch order: `Pipeline.gather(branches) >>
    VectorCombiner()` as one stage. Each branch acts row by row: a
    fusable stage, or the `FusedBatchTransformer` the optimizer makes of a
    many-stage branch."""

    fusable = True

    def __init__(self, branches: Sequence[Transformer]):
        self.branches = list(branches)
        self._layouts = {}  # input item shape -> (column bounds, dtype)

    @property
    def label(self) -> str:
        return "Gather[" + " | ".join(b.label for b in self.branches) + "]"

    @property
    def chunkable(self) -> bool:
        return all(getattr(b, "chunkable", False) for b in self.branches)

    def _fns(self):
        return [b.batch_fn() for b in self.branches]

    def batch_fn(self):
        fns = self._fns()
        return lambda x: torch.cat([f(x) for f in fns], dim=-1)

    def fuse(self):
        """The JAX package's key: ``("GatherConcat",)`` and each branch's
        key."""
        fused = [stage_fuse(b) for b in self.branches]
        return (("GatherConcat",) + tuple(f[0] for f in fused),
                tuple(f[1] for f in fused))

    def writer(self):
        """``(layout, write)``: ``layout(xb)`` is the concatenated item
        shape and dtype for rows like ``xb``; ``write(xb, out)`` runs every
        branch on ``xb`` and writes its output into its columns of
        ``out`` (rows of ``xb``). The column bounds come from one row
        through each branch, once per input item shape."""
        fns = self._fns()

        def bounds(xb):
            key = tuple(xb.shape[1:])
            if key not in self._layouts:
                ys = [f(xb[:1]) for f in fns]
                cols = [0]
                for y in ys:
                    cols.append(cols[-1] + y.shape[-1])
                self._layouts[key] = (cols, ys[0].dtype, ys[0].shape[1:-1])
            return self._layouts[key]

        def layout(xb):
            cols, dtype, inner = bounds(xb)
            return tuple(inner) + (cols[-1],), dtype

        def write(xb, out):
            cols = bounds(xb)[0]
            for f, c0, c1 in zip(fns, cols, cols[1:]):
                out[..., c0:c1] = f(xb)

        return layout, write


def _is_sum_pooler(stage) -> bool:
    from ..images.core import Pooler

    return (isinstance(stage, Pooler) and stage.pool_fn == "sum"
            and stage.pixel_fn is None)


def _peephole(stages):
    """Merge adjacent (Convolver?, SymmetricRectifier, Pooler[sum])
    stages into one kernel stage."""
    from ..images.core import Convolver, SymmetricRectifier

    out, i = [], 0
    while i < len(stages):
        s = stages[i]
        if (isinstance(s, Convolver) and i + 2 < len(stages)
                and isinstance(stages[i + 1], SymmetricRectifier)
                and _is_sum_pooler(stages[i + 2])):
            r, p = stages[i + 1], stages[i + 2]
            out.append(_ConvRectifyPoolStage(s, r.alpha, r.max_val,
                                             p.pool_size, p.stride))
            i += 3
        elif (isinstance(s, SymmetricRectifier) and i + 1 < len(stages)
              and _is_sum_pooler(stages[i + 1])):
            p = stages[i + 1]
            out.append(_RectifyPoolStage(s.alpha, s.max_val, p.pool_size,
                                         p.stride))
            i += 2
        else:
            out.append(s)
            i += 1
    return out


def stage_fuse(stage) -> Tuple[tuple, tuple]:
    """(static key, parameters) of a peepholed stage (`_stage_fuse`,
    `:190-224`, without the function): the stage's ``fuse()``, or an
    id-keyed opaque key; wrapped as ``(key, "masked")`` when the stage
    re-zeroes padded rows (``fuse_masks_output``)."""
    fuse = getattr(stage, "fuse", None)
    key, params = fuse() if fuse is not None else (("opaque", id(stage)), ())
    if getattr(stage, "fuse_masks_output", False):
        key = (key, "masked")
    return key, params


def stage_statics(stages) -> tuple:
    """The peepholed chain's static keys: the matcher's input."""
    return tuple(stage_fuse(s)[0] for s in _peephole(list(stages)))


def plan_chain_kernel(statics) -> Optional[Tuple[int, int, str]]:
    """``(start, stop, family)`` of the first maximal run of two or more
    stages that `lowerability` accepts, or None."""
    statics = tuple(statics)
    for start in range(len(statics) - 1):
        for stop in range(len(statics), start + 1, -1):
            verdict = lowerability(statics[start:stop])
            if verdict["lowerable"]:
                return start, stop, verdict["family"]
    return None


class FusedBatchTransformer(Transformer):
    """Run ``stages`` (after the peephole) over consecutive microbatches
    of ``microbatch`` rows; the last microbatch is ragged.

    ``planned_kernel`` is ``(start, stop, family)`` over the peepholed
    stages, or None: that sub-trail runs as one chain kernel launch. In
    the JAX package the unified planner sets the tag, and its kernel axis
    takes any run that lowers, since it prices the kernel at one pass
    over device memory against a round trip per stage boundary
    (`analysis/roofline.py:907-920`). The port has no such planner (the
    JAX unified planner prices TPU programs), so every transformer, a
    pipeline's own featurizer or one the optimizer's fusion pass builds,
    tags itself with the same choice: the first maximal run that lowers
    (`plan_chain_kernel`). A nested transformer is one stage keyed
    ``("FusedChain", ...)``, which no run takes in."""

    fusable = True

    def __init__(self, stages: Sequence[Transformer], microbatch: int = 2048):
        self.stages = list(stages)
        self.microbatch = microbatch
        self.fused = _peephole(self.stages)
        self.planned_kernel = plan_chain_kernel(
            stage_fuse(s)[0] for s in self.fused)
        self._chain = None  # (tag, chain fn) of the planned sub-trail
        self.microbatches_run = 0  # microbatches through batch_fn, ever
        self._init_graphs()

    def _init_graphs(self) -> None:
        # the padded loops' graphs (`run_rung`) by (item shape, dtype,
        # rows, trip, device), and the eager calls made at each key
        self._graphs = {}
        self._eager_calls = {}
        self.graph_lock = threading.Lock()
        #: (item shape, dtype, device) keys the chain has run at: a
        #: warm-up of one of them has nothing left to do
        self._ran_at = set()

    @property
    def label(self) -> str:
        return "Fused[" + " >> ".join(s.label for s in self.stages) + "]"

    @property
    def chunkable(self) -> bool:
        """A fused chain distributes over chunks iff every stage does."""
        return all(getattr(s, "chunkable", False) for s in self.stages)

    def fuse(self):
        """``(("FusedChain",) + the peepholed stages' keys, their
        parameters)`` (`:417-433`): inside a larger chain this
        transformer is one stage, which no chain kernel absorbs."""
        fused = [stage_fuse(s) for s in self.fused]
        return (("FusedChain",) + tuple(f[0] for f in fused),
                tuple(f[1] for f in fused))

    def __getstate__(self):
        # the chain function holds its launch plans and a closure, a graph
        # its buffers on the card: both are rebuilt at first use
        state = dict(self.__dict__)
        state["_chain"] = None
        for key in ("_graphs", "_eager_calls", "graph_lock", "_ran_at"):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_graphs()

    def _chain_fn(self):
        """The planned sub-trail's chain function, built once per tag and
        kept, so that its launch plans (one per item shape) serve every
        later microbatch and apply. The stages' parameters are read here
        once: fitted stages do not change, as the JAX package's
        immutable parameters do not. A tag that does not lower raises."""
        if self._chain is not None and self._chain[0] == self.planned_kernel:
            return self._chain[1]
        start, stop, family = self.planned_kernel
        if not 0 <= start < stop <= len(self.fused):
            raise ValueError(f"planned_kernel {self.planned_kernel} is out "
                             f"of range for {len(self.fused)} stages")
        fused = [stage_fuse(s) for s in self.fused[start:stop]]
        statics = [f[0] for f in fused]
        kern = build_chain_fn(statics, tuple(f[1] for f in fused), family)
        if kern is None:
            verdict = lowerability(statics)
            raise ValueError(
                f"planned_kernel {self.planned_kernel} does not lower: the "
                f"matcher says family {verdict['family']!r} "
                f"({verdict['reason']})")
        self._chain = (self.planned_kernel, kern)
        return kern

    def _stage_fns(self):
        """One batch function per peepholed stage, with the planned
        sub-trail swapped for its chain kernel; and ``(layout, write)``
        where the last stage writes its rows into a given ``out`` (the
        planned chain kernel, or a gather stage), else None: ``layout(y)``
        is the item shape and dtype of its rows for input rows ``y``. The
        stages never fall back to running one by one."""
        fns = [s.batch_fn() for s in self.fused]
        if self.planned_kernel is None:
            if self.fused and isinstance(self.fused[-1], _GatherConcatStage):
                return fns, self.fused[-1].writer()
            return fns, None
        start, stop, _ = self.planned_kernel
        kern = self._chain_fn()
        # one dataset device: no padded rows, so no row mask
        fns[start:stop] = [lambda xb: kern(xb.contiguous())]
        last = None
        if stop == len(self.fused) and kern.plans is not None:
            last = (lambda y: (kern.plan_for(y).out_shape, torch.float32),
                    kern)
        return fns, last

    def batch_fn(self):
        fns, last = self._stage_fns()
        head = fns if last is None else fns[:-1]

        def fn(x):
            n, out = x.shape[0], None
            self._ran_at.add((tuple(x.shape[1:]), x.dtype, x.device))
            for start in range(0, n, self.microbatch):
                tally(self, "microbatches_run")
                with span("microbatch", cat="chunk", idx=start //
                          self.microbatch, rows=min(self.microbatch,
                                                    n - start)):
                    y = _run(head, x[start:start + self.microbatch])
                    if last is not None:
                        # the last stage writes its rows of the result
                        layout, write = last
                        y = y.contiguous()
                        if out is None:
                            shape, dtype = layout(y)
                            out = torch.empty((n,) + tuple(shape),
                                              dtype=dtype, device=y.device)
                        write(y, out[start:start + y.shape[0]])
                        continue
                    if out is None:
                        out = torch.empty((n,) + tuple(y.shape[1:]),
                                          dtype=y.dtype, device=y.device)
                    out[start:start + y.shape[0]] = y
            return out if out is not None else _run(fns, x)

        fn.owner = self  # a fused chain: host streams may capture it
        return fn

    #: calls at a `run_rung` key that run the padded loop eagerly before
    #: the key's graph is captured: a chain applied once at a shape pays
    #: no capture, and the capture's own eager run is the call's result
    eager_calls_before_capture = 1

    def _trip_fn(self, trip: int):
        """The chain over rows in consecutive ``trip``-row slices, each
        slice's result written into its rows of one output."""
        fn = FusedBatchTransformer.batch_fn(self)
        if trip % self.microbatch == 0:
            return fn  # it runs microbatches of its own, inside each trip

        def loop(x):
            out = None
            for start in range(0, x.shape[0], trip):
                y = fn(x[start:start + trip])
                if out is None:
                    out = y.new_empty((x.shape[0],) + tuple(y.shape[1:]))
                out[start:start + trip] = y
            return out

        return loop

    @staticmethod
    def _graph_key(item_shape, dtype, rows: int, trip: int, device) -> tuple:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        return tuple(item_shape), dtype, rows, trip, device

    def _capture(self, key, x: Optional[torch.Tensor]):
        """The padded loop at ``key`` captured (`utils/graphs.py`): after
        an eager run on ``x`` (the call's rows, its result kept as the
        loop's ``first``) or, for a warm-up, on zero rows. Called under
        ``graph_lock``."""
        from ...utils.graphs import CapturedLoop

        item_shape, dtype, rows, trip, device = key
        fn = self._trip_fn(trip)
        t0 = time.perf_counter()
        loop = CapturedLoop(fn, (rows,) + item_shape, dtype, device, x,
                            keep=(self._chain, tuple(self.fused)))
        record_compile(self.label, time.perf_counter() - t0, cold=True,
                       kind="graph")
        self._graphs[key] = loop
        tally(_GRAPH_CAPTURES)
        return loop

    def run_rung(self, x: torch.Tensor, rows: int,
                 trip: int) -> torch.Tensor:
        """The chain over ``x`` padded with zero rows to ``rows`` (a
        whole number of ``trip``-row trips, or one trip), its trips one
        after another; ``x``'s rows of the result. On the card the first
        `eager_calls_before_capture` calls at an (item shape, dtype,
        rows, trip) key run the loop eagerly over the real rows alone
        (no graph needs the padded shape yet), the next one captures it
        (its eager run before the capture is its result), and every later
        one replays the graph. A capture that fails raises. On the CPU
        the loop runs eagerly. Counts ``megafusion.programs`` (one a
        call) and ``megafusion.scan_trips`` (the trips run), and a
        ``megafused_program`` span."""
        trips = -(-rows // trip)
        tally(_PROGRAMS)
        tally(_SCAN_TRIPS, n=trips)
        if current_tracer() is None:  # the span's label costs a walk
            return self._run_rung(x, rows, trip)
        with span("megafused_program", cat="node", megafused=True,
                  scan_trips=trips, rows=x.shape[0], label=self.label):
            return self._run_rung(x, rows, trip)

    def _run_rung(self, x: torch.Tensor, rows: int,
                  trip: int) -> torch.Tensor:
        n = x.shape[0]
        if x.device.type == "cuda":
            key = self._graph_key(x.shape[1:], x.dtype, rows, trip, x.device)
            with self.graph_lock:
                loop = self._graphs.get(key)
                if loop is None:
                    calls = self._eager_calls.get(key, 0)
                    if calls >= self.eager_calls_before_capture:
                        loop = self._capture(key, x)
                        first, loop.first = loop.first, None
                        return first
                    self._eager_calls[key] = calls + 1
            if loop is not None:
                out = loop(x)
                tally(_GRAPH_REPLAYS)
                return out
        if x.device.type == "cuda" or rows == n:
            # no graph to fit yet: the real rows alone, in the same trips
            return self._trip_fn(trip)(x)
        x = torch.cat([x, x.new_zeros((rows - n,) + tuple(x.shape[1:]))])
        return self._trip_fn(trip)(x)[:n]

    def is_warm(self, item_shape, dtype, count: int, device) -> bool:
        """Whether a warm-up for these rows has nothing left to do."""
        return (tuple(item_shape), dtype, torch.device(device)) in \
            self._ran_at

    def warmup(self, item_shape, dtype, count: int, device) -> None:
        """Ready the chain for rows of ``item_shape``: build its launch
        plans (one per item shape) and load its kernels by one eager run
        on a zero row, whose launches count nowhere. Nothing to do where
        the chain has run at that item shape."""
        if self.is_warm(item_shape, dtype, count, device):
            return
        x = torch.zeros((1,) + tuple(item_shape), dtype=dtype,
                        device=device)
        with tallied({}):
            FusedBatchTransformer.batch_fn(self)(x)


class MegafusedBatchTransformer(FusedBatchTransformer):
    """A whole apply path as one chain whose chunk loop is one CUDA graph
    replay (`keystone_tpu/nodes/util/fusion.py:745-804`, the JAX
    package's in-program ``lax.scan``), built by
    `workflow/fusion_rule.py::MegafusionRule`.

    On a CUDA tensor of n rows, ``batch_fn`` pads the rows to the rung
    (`rung`: the power-of-two ladder up to one microbatch, else
    ``ceil(n / microbatch)`` trips of ``microbatch`` rows) and runs the
    padded loop (`run_rung`): eagerly at the first call at an (item
    shape, dtype, rung), captured at the second, replayed from then on
    (or from the first call, after a warm-up captured it). A replay
    copies the rows into the graph's static input and returns a copy of
    the real rows (the next replay overwrites the graph's output). A
    capture that fails raises. On the CPU the same padded loop runs
    eagerly over the plain versions. Counts, in the registry:
    ``megafusion.graph_captures``, ``megafusion.graph_replays``,
    ``megafusion.programs`` and ``megafusion.scan_trips`` (trips run);
    the kernels' launches and the nested chains' ``microbatches_run``
    grow at each replay by what the capture recorded."""

    def rung(self, n: int) -> int:
        """Rows a call of ``n`` rows runs at."""
        mb = self.microbatch
        if n <= mb:
            return min(mb, 1 << max(0, n - 1).bit_length())
        return -(-n // mb) * mb

    def batch_fn(self):
        eager = FusedBatchTransformer.batch_fn(self)

        def fn(x):
            n = x.shape[0]
            if n == 0:
                return eager(x)
            return self.run_rung(x, self.rung(n), self.microbatch)

        # its own padded loop per call: a host stream runs it chunk by
        # chunk
        fn.owner = None
        return fn

    def is_warm(self, item_shape, dtype, count: int, device) -> bool:
        device = torch.device(device)
        if device.type != "cuda":
            return super().is_warm(item_shape, dtype, count, device)
        return self._rung_key(item_shape, dtype, count, device) in \
            self._graphs

    def _rung_key(self, item_shape, dtype, count: int, device) -> tuple:
        return self._graph_key(item_shape, dtype, self.rung(max(1, count)),
                               self.microbatch, device)

    def warmup(self, item_shape, dtype, count: int, device) -> None:
        """Capture the graph of ``count`` rows' rung (on the card; one
        eager run on the CPU), counting no launch."""
        device = torch.device(device)
        if device.type != "cuda":
            super().warmup(item_shape, dtype, count, device)
            return
        key = self._rung_key(item_shape, dtype, count, device)
        with self.graph_lock:
            if key not in self._graphs:
                self._capture(key, None)
