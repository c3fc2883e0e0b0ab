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
``chunkable`` when every stage is (`:292, 405-410`). On meta tensors
(the static analyzer's run) the stages run once, with no microbatch
loop, rung, count or capture. The precision planner's tags
(`:355-369`) are enforced here: ``planned_precision`` casts each
peepholed stage's output to its planned storage dtype (the last entry
restores the unplanned output dtype), and ``planned_matmul_precision``
runs the stages under a bf16 `torch.autocast` whose bf16 outputs are
cast back to float32 at each stage. The JAX package's program caching
and sharding tags have no counterpart here.

Telemetry (`:535-555, 784-791`): each microbatch a ``chunk`` span, each
padded loop a ``megafused_program`` span and one count in
``megafusion.programs`` and its trips in ``megafusion.scan_trips``; a
capture counts in ``megafusion.graph_captures`` and as a cold compile
(`telemetry/compile_events.py`), a replay in ``megafusion.graph_replays``.
Counts go through `tally`, so what a capture records is added at every
replay. A call that runs a planned chain kernel is one ``chain_kernel``
span (`:541-553`: ``label``, ``family``, ``stages``, ``rows``,
``predicted_seconds``, ``statically_verified``), around the eager call
or around the graph replay that holds the kernel, since no Python runs
inside a replay. The span waits for the card before it closes, so its
duration is the kernel's call and not its enqueue; it is recorded, and
the card waited for, only while a tracer is active and never inside a
capture, so an untraced run makes no extra synchronizing call. It is
recorded only on the card, where the kernel launches (on the CPU the
plain version runs), and once a call: a padded loop's trips, and the
chains nested in a megafused one, open no span of their own inside it.
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
from ...data.dataset import mask_rows
from ...telemetry.instrument import record_dispatch, sync_value
from ...telemetry.metrics import counter, tallied, tally, tallying
from ...telemetry.spans import current_tracer, span
from ...workflow.pipeline import Transformer

_PROGRAMS = counter("megafusion.programs")
_SCAN_TRIPS = counter("megafusion.scan_trips")
_GRAPH_CAPTURES = counter("megafusion.graph_captures")
_GRAPH_REPLAYS = counter("megafusion.graph_replays")
#: whether a ``chain_kernel`` span is open on this thread
_KERNEL_SPAN = threading.local()


class _RectifyPoolStage(Transformer):
    """SymmetricRectifier >> Pooler(sum) through the rectify+pool kernel."""

    fusable = True
    precision_tolerance = "tolerant"  # both fused members are tolerant

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
    activations never reach device memory. Its input may be bf16 (a
    planned storage trail): the kernel reads it as it is."""

    fusable = True
    precision_tolerance = "tolerant"  # all three fused members are

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


def _run(fns, xb, mb=None):
    for fn in fns:
        xb = fn(xb, mb)
    return xb


def _stage_fn(stage):
    """``stage``'s batch function as ``fn(rows, mask)``, ``mask`` the
    rows' validity or None: a nested chain takes the mask through its
    own loop, and a stage that re-zeroes padded rows
    (``fuse_masks_output``) has its output rows multiplied by it, as
    JAX's fused program re-applies the mask at the stage's place
    (`:480-532`)."""
    fn = stage.batch_fn()
    if isinstance(stage, FusedBatchTransformer):
        return fn
    if getattr(stage, "fuse_masks_output", False):
        return lambda xb, mb: fn(xb) if mb is None else mask_rows(fn(xb), mb)
    return lambda xb, mb: fn(xb)


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

    @property
    def precision_tolerance(self):
        """Tolerant iff every branch is: the collapsed diamond takes the
        weakest member's contract."""
        tols = {getattr(b, "precision_tolerance", None)
                for b in self.branches}
        return "tolerant" if tols == {"tolerant"} else "exact"

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
    the JAX package only the unified planner sets the tag, where its
    joint plan is enforced; its kernel axis takes any run that lowers,
    since it prices the kernel at one pass over device memory against a
    round trip per stage boundary (`analysis/roofline.py:907-920`). On
    the card the alternative is one launch a stage, so every transformer
    here, a pipeline's own featurizer or one the fusion pass builds,
    tags itself with the choice that kernel axis makes, the first
    maximal run that lowers (`plan_chain_kernel`), and keeps it where the
    joint plan is not enforced (`analysis/plan_ir.py` records the same
    tag as its ``kernel`` decision). That is the one place the port's
    plans differ from JAX's. A nested transformer is one stage keyed
    ``("FusedChain", ...)``, which no run takes in.

    ``planned_precision`` (one storage dtype name or None per peepholed
    stage) and ``planned_matmul_precision`` are set by the precision and
    unified planners on a copy (`tagged_copy`); see the module
    docstring."""

    fusable = True

    #: the precision planner's per-stage storage dtypes, or None
    planned_precision = None
    #: "bfloat16": the stages run under a bf16 autocast, or None
    planned_matmul_precision = None
    #: set on a copy the unified planner tagged
    planned_by_unified = False
    #: the unified planner's priced seconds for the planned kernel
    planned_kernel_seconds = None
    #: the sharding planner's placement of this program's output (a
    #: `PartitionSpec`, `workflow/optimizer.py::ShardingPlannerRule`), or
    #: None: the default placement
    planned_out_spec = None

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

    @property
    def precision_tolerance(self):
        """Tolerant iff every member is: inside a larger graph the
        precision planner sees the whole chain as one stage."""
        tols = {getattr(s, "precision_tolerance", None)
                for s in self.stages}
        return "tolerant" if tols == {"tolerant"} else "exact"

    @property
    def takes_windows(self) -> bool:
        """A fused chain runs its rows in independent microbatches, so a
        spilled or out-of-core input reaches it in row windows whatever
        its stages declare."""
        return True

    def tagged_copy(self, **tags) -> "FusedBatchTransformer":
        """A copy carrying the planner's ``tags``, with launch plans and
        graphs of its own: a tagged program never replays the untagged
        one's graphs."""
        import copy

        new = copy.copy(self)
        for name, value in tags.items():
            setattr(new, name, value)
        new._chain = None
        new._init_graphs()
        return new

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
        is the item shape and dtype of its rows for input rows ``y``. Each
        function takes ``(rows, mask)`` and ``write`` ``(rows, out,
        mask)``: ``mask`` is the rows' validity, or None where no row is
        padding (`_stage_fn`; the planned kernel applies it itself). The
        stages never fall back to running one by one."""
        fns = [_stage_fn(s) for s in self.fused]
        casts = self._storage_casts()
        if self.planned_kernel is None:
            fns = self._planned(fns, casts)
            if self.fused and isinstance(self.fused[-1], _GatherConcatStage):
                layout, write = self.fused[-1].writer()
                if casts[-1] is not None:
                    # the writes cast into the restored output dtype
                    return fns, (lambda y: (layout(y)[0], casts[-1]),
                                 lambda y, out, mb: write(y, out))
                return fns, (layout, lambda y, out, mb: write(y, out))
            return fns, None
        start, stop, _ = self.planned_kernel
        kern = self._chain_fn()
        # the rows' mask goes into the kernel, whose masked stages
        # re-zero padded rows in place, as JAX's fused program does.
        # Inside the kernel's slice every boundary stays on chip, so
        # only the cast at the slice's end applies (`:653-669`).
        fns[start:stop] = [lambda xb, mb: kern(xb.contiguous(), mask=mb)]
        casts[start:stop] = [casts[stop - 1]]
        if start > 0 and casts[start - 1] == torch.bfloat16:
            # K4 reads float32 rows: a bf16 run ends at the slice's input
            casts[start - 1] = torch.float32
        fns = self._planned(fns, casts)
        last = None
        if stop == len(self.fused) and kern.plans is not None:
            last = (lambda y: (kern.plan_for(y).out_shape, torch.float32),
                    kern)
        return fns, last

    def apply_batch(self, data):
        """The chain over the rows held here: on a mesh, this rank's,
        where K1, or K4 where planned, launch on them alone. Where those
        rows include padded ones, their mask goes through the chain's
        loop (and its graph), and each stage that re-zeroes padded rows
        (``fuse_masks_output``) applies it at its place, inside a planned
        K4 too, as JAX's fused program does (`:480-532`): a padded row
        never reaches a reduction unmasked. A ``planned_out_spec`` places
        the output as the sharding planner chose (JAX's
        ``with_sharding_constraint`` on the program's output, `:396-405`):
        the result lands in that layout (`Dataset.with_data`'s
        ``spec``)."""
        padded = getattr(data, "has_padding", False)
        spec = self.planned_out_spec
        if spec is None and not padded:
            return super().apply_batch(data)
        if not hasattr(data, "with_data") or getattr(
                data, "is_spilled", False) or getattr(
                data, "is_out_of_core", False):
            out = super().apply_batch(data)
            return out.reshard(spec) if hasattr(out, "reshard") else out
        record_dispatch()
        y = (self.batch_fn()(data.array, data.mask) if padded
             else self.batch_fn()(data.array))
        return data.with_data(y, spec=spec)

    def _storage_casts(self) -> list:
        """The torch dtype each peepholed stage's output is cast to, or
        None: ``planned_precision`` where it is aligned with the
        stages (a stale tag is ignored, as in JAX's `:640-644`)."""
        planned = self.planned_precision
        if planned is None or len(planned) != len(self.fused):
            return [None] * len(self.fused)
        return [getattr(torch, name) if name is not None else None
                for name in planned]

    def _planned(self, fns, casts):
        """``fns`` with each stage's planned storage cast applied to its
        floating output, under a bf16 autocast where
        ``planned_matmul_precision`` says so."""
        autocast = self.planned_matmul_precision == "bfloat16"
        if not autocast and not any(c is not None for c in casts):
            return fns

        def planned(fn, dtype):
            def run(xb, mb):
                if autocast and xb.device.type != "meta":
                    with torch.autocast(xb.device.type,
                                        dtype=torch.bfloat16):
                        y = fn(xb, mb)
                    if y.dtype == torch.bfloat16 \
                            and xb.dtype != torch.bfloat16:
                        y = y.float()  # the autocast's own bf16 result
                else:
                    y = fn(xb, mb)
                if dtype is not None and y.is_floating_point() \
                        and y.dtype != dtype:
                    y = y.to(dtype)
                return y

            return run

        return [planned(fn, dtype) for fn, dtype in zip(fns, casts)]

    def _kernel_span_args(self, rows: int) -> Optional[dict]:
        """The ``chain_kernel`` span's arguments for a call of ``rows``
        rows through this chain, or None where no planned chain kernel
        runs in it: this chain's own, else the first nested chain's (a
        megafused chain holds its fused members as stages)."""
        for chain in [self] + list(self.fused):
            if isinstance(chain, FusedBatchTransformer) \
                    and chain.planned_kernel is not None:
                start, stop, family = chain.planned_kernel
                return dict(label=chain.label, family=family,
                            stages=stop - start, rows=rows,
                            predicted_seconds=chain.planned_kernel_seconds,
                            statically_verified=None)
        return None

    def _kernel_span(self, x: torch.Tensor):
        """A ``chain_kernel`` span for a call on ``x``, or None: only on
        the card, where the planned kernel launches (on the CPU its
        plain version runs), only under a tracer, and never inside a
        capture or a warm-up (`tallying`: neither is a dispatch)."""
        if x.device.type != "cuda" or current_tracer() is None \
                or tallying() or getattr(_KERNEL_SPAN, "open", False):
            return None
        args = self._kernel_span_args(x.shape[0])
        return None if args is None else span("chain_kernel", cat="node",
                                               **args)

    def _spanned(self, loop):
        """``loop`` in one ``chain_kernel`` span a call where one is due
        (`_kernel_span`), closed once the card has finished the call's
        work."""

        def fn(x, mask=None):
            kspan = self._kernel_span(x)
            if kspan is None:
                return loop(x, mask)
            with kspan:
                _KERNEL_SPAN.open = True
                try:
                    out = loop(x, mask)
                    sync_value(out)
                finally:
                    _KERNEL_SPAN.open = False
            return out

        return fn

    def _loop(self):
        """The chain's microbatch loop, with no span of its own."""
        fns, last = self._stage_fns()
        head = fns if last is None else fns[:-1]
        return self._microbatch_loop(fns, head, last)

    def batch_fn(self):
        loop = self._loop()
        fn = loop if self.planned_kernel is None else self._spanned(loop)
        fn.owner = self  # a fused chain: host streams may capture it
        return fn

    def _microbatch_loop(self, fns, head, last):
        """The chain over ``x`` (``mask``: its rows' validity, or None)
        in microbatches of ``microbatch`` rows, each a ``chunk`` span; on
        meta tensors the stages once."""

        def fn(x, mask=None):
            if x.device.type == "meta":
                # the static analyzer's run (`ops/meta.py`): the stages
                # once, no microbatch loop, nothing counted
                return _run(fns, x)
            n, out = x.shape[0], None
            self._ran_at.add((tuple(x.shape[1:]), x.dtype, x.device))
            for start in range(0, n, self.microbatch):
                tally(self, "microbatches_run")
                stop = start + self.microbatch
                mb = None if mask is None else mask[start:stop]
                with span("microbatch", cat="chunk", idx=start //
                          self.microbatch, rows=min(self.microbatch,
                                                    n - start)):
                    y = _run(head, x[start:stop], mb)
                    if last is not None:
                        # the last stage writes its rows of the result
                        layout, write = last
                        y = y.contiguous()
                        if out is None:
                            shape, dtype = layout(y)
                            out = torch.empty((n,) + tuple(shape),
                                              dtype=dtype, device=y.device)
                        write(y, out[start:start + y.shape[0]], mb)
                        continue
                    if out is None:
                        out = torch.empty((n,) + tuple(y.shape[1:]),
                                          dtype=y.dtype, device=y.device)
                    out[start:start + y.shape[0]] = y
            return out if out is not None else _run(fns, x, mask)

        return fn

    #: calls at a `run_rung` key that run the padded loop eagerly before
    #: the key's graph is captured: a chain applied once at a shape pays
    #: no capture, and the capture's own eager run is the call's result
    eager_calls_before_capture = 1

    def _trip_fn(self, trip: int):
        """The chain over rows in consecutive ``trip``-row slices, each
        slice's result written into its rows of one output; one
        ``chain_kernel`` span for the whole call, where one is due."""
        fn = self._loop()
        if trip % self.microbatch != 0:
            inner = fn

            def fn(x, mask=None):
                out = None
                for start in range(0, x.shape[0], trip):
                    y = inner(x[start:start + trip], None if mask is None
                              else mask[start:start + trip])
                    if out is None:
                        out = y.new_empty((x.shape[0],) + tuple(y.shape[1:]))
                    out[start:start + trip] = y
                return out

        # else it runs microbatches of its own, inside each trip; the
        # span is this chain's planned kernel's or a nested chain's
        return self._spanned(fn)

    @staticmethod
    def _graph_key(item_shape, dtype, rows: int, trip: int, device,
                   masked: bool = False) -> tuple:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        return tuple(item_shape), dtype, rows, trip, device, masked

    def _capture(self, key, x: Optional[torch.Tensor],
                 mask: Optional[torch.Tensor] = None):
        """The padded loop at ``key`` captured (`utils/graphs.py`): after
        an eager run on ``x`` (the call's rows, its result kept as the
        loop's ``first``; ``mask``, their row mask, where the key is a
        masked one) or, for a warm-up, on zero rows. Called under
        ``graph_lock``."""
        from ...utils.graphs import CapturedLoop

        item_shape, dtype, rows, trip, device, _ = key
        fn = self._trip_fn(trip)
        t0 = time.perf_counter()
        loop = CapturedLoop(fn, (rows,) + item_shape, dtype, device, x,
                            keep=(self._chain, tuple(self.fused)),
                            mask=mask)
        record_compile(self.label, time.perf_counter() - t0, cold=True,
                       kind="graph")
        self._graphs[key] = loop
        tally(_GRAPH_CAPTURES)
        return loop

    def run_rung(self, x: torch.Tensor, rows: int, trip: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The chain over ``x`` padded with zero rows to ``rows`` (a
        whole number of ``trip``-row trips, or one trip), its trips one
        after another; ``x``'s rows of the result. ``mask``: ``x``'s row
        mask (a mesh rank's rows with padded ones), which the loop and
        its graph take with the rows, or None. On the card the first
        `eager_calls_before_capture` calls at an (item shape, dtype,
        rows, trip, masked) key run the loop eagerly over the real rows alone
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
            return self._run_rung(x, rows, trip, mask)
        with span("megafused_program", cat="node", megafused=True,
                  scan_trips=trips, rows=x.shape[0], label=self.label):
            return self._run_rung(x, rows, trip, mask)

    def _run_rung(self, x: torch.Tensor, rows: int, trip: int,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
        n = x.shape[0]
        if x.device.type == "cuda":
            key = self._graph_key(x.shape[1:], x.dtype, rows, trip, x.device,
                                  mask is not None)
            with self.graph_lock:
                loop = self._graphs.get(key)
                if loop is None:
                    calls = self._eager_calls.get(key, 0)
                    if calls >= self.eager_calls_before_capture:
                        loop = self._capture(key, x, mask)
                        first, loop.first = loop.first, None
                        return first
                    self._eager_calls[key] = calls + 1
            if loop is not None:
                out = self._spanned(loop)(x, mask)
                tally(_GRAPH_REPLAYS)
                return out
        if x.device.type == "cuda" or rows == n:
            # no graph to fit yet: the real rows alone, in the same trips
            return self._trip_fn(trip)(x, mask)
        x = torch.cat([x, x.new_zeros((rows - n,) + tuple(x.shape[1:]))])
        if mask is not None:
            mask = torch.cat([mask, mask.new_zeros(rows - n)])
        return self._trip_fn(trip)(x, mask)[:n]

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

        def fn(x, mask=None):
            n = x.shape[0]
            if n == 0 or x.device.type == "meta":
                return eager(x, mask)
            if mask is None:  # the form host streams call too
                return self.run_rung(x, self.rung(n), self.microbatch)
            return self.run_rung(x, self.rung(n), self.microbatch, mask)

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
