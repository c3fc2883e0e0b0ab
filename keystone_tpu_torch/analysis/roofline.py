"""Static roofline analyzer: FLOP and byte pricing of stage bodies run on
meta tensors, a time-domain cost model, and kernel-candidate lints (the
KP8xx tier).

Counterpart of `keystone_tpu/analysis/roofline.py:1-977`. Where the JAX
package walks the jaxpr of each stage body, the port runs the body once
on meta tensors (`analysis/specs.py`) under `_CostMode`, a
`TorchDispatchMode` that prices every aten op the body issues with
JAX's per-primitive rules (`_eqn_cost`, `:148-200`):

  - ``mm``/``bmm``/``addmm``/``baddbmm``/``mv``/``dot``: 2·out·contraction;
  - ``convolution``: 2·out·kernel·in_ch;
  - FFT (``_fft_r2c``, ``_fft_c2c``, ``_fft_c2r``): 5·n·log2 n a batch;
  - reductions (sums, maxima, arg-maxima, norms, cumulative sums): at
    input size; ``sort``/``topk``: input·log2 n;
  - copies, casts, ``cat``, ``pad``, index ops and fills: no FLOPs,
    their input and output bytes as movement (the traffic KP802 weighs);
  - views (torch's reshape, permute, slices: no bytes move) and ops that
    only allocate (``empty``, ``arange``): free, where JAX's reshape and
    transpose count as movement;
  - pooling windows: output elements × window;
  - everything else: one FLOP per output element.

`torch.utils.flop_counter.FlopCounterMode` counts only the products, so
it does not reproduce JAX's totals. A kernel wrapper given a meta tensor
reports its own FLOPs and bytes (`ops/meta.py`); the mode adds the FLOPs,
and the trail row carries the bytes as ``kernel_bytes``.

The model: a stage's bytes are its input plus output element bytes
(stage-at-a-time, × the propagated count); its time is
``stage_cost = max(flops/peak_flops, bytes/peak_bw)`` on the rates of
`nodes/learning/calibrate.py::machine_rates` (on the card, its measured
`cuda_calibration.json`). A fitted apply (`DelegatingOperator`, a
fused chain's fit slot) has no body before the fit and is modeled as a
dense map (2·in·out FLOPs an item, ``flop_source="modeled"``).

Lints: KP801 (a bandwidth-bound fan-out-free chain of ≥ 2 stages, with
the boundary bytes one kernel would keep on chip), KP802 (a stage whose
pure data movement outweighs its compute and boundary bytes), KP803 (the
plan in seconds), KP804 (a megafused loop whose trip is under the
dispatch floor) and KP805 (a KP801 candidate that lowers to the
elementwise chain kernel, `ops/chain_kernels.py::lowerability`, and
beats the stage-at-a-time chain).

``DISPATCH_OVERHEAD_S`` is the JAX package's constant (`:102`), fitted
to XLA program dispatch, kept so that the port's certificates equal
JAX's; it is not a measurement of the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..workflow.graph import Graph, GraphId, NodeId, SinkId
from .diagnostics import Diagnostic, Severity
from .memory import _fmt_bytes, resolve_chunk_rows
from .propagate import _label, toposort
from .specs import (
    UNKNOWN,
    DataSpec,
    MetaMode,
    TransformerSpec,
    element_nbytes,
    from_meta,
    is_known,
    to_meta,
    tree_leaves,
)

#: per-program dispatch floor KP804 amortizes against: the JAX package's
#: model of XLA program dispatch (`keystone_tpu/analysis/roofline.py:102`)
DISPATCH_OVERHEAD_S = 5e-5

# ------------------------------------------------------------ aten pricing

#: ops that move bytes but compute nothing (JAX's `_MOVEMENT_PRIMS`):
#: copies, casts, joins, pads, gathers and fills. A torch view (reshape,
#: permute, unsqueeze, slice, ...) moves nothing and is free here, where
#: JAX's reshape and transpose count: the copy a view needs shows up as
#: its ``clone``/``contiguous`` instead
_MOVEMENT_OPS = frozenset({
    "clone", "copy_", "copy", "_to_copy", "cat", "stack",
    "constant_pad_nd", "pad", "reflection_pad2d", "replication_pad2d",
    "index", "index_select", "gather", "scatter", "slice_scatter",
    "select_scatter", "repeat", "flip", "roll", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "fill", "fill_", "zero_",
    "new_zeros", "new_ones", "new_full", "masked_select", "lift_fresh_copy",
    "masked_fill", "masked_fill_", "one_hot",
})

#: views and ops that neither compute nor read (JAX's `_FREE_PRIMS`)
_FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "arange", "detach", "lift_fresh", "scalar_tensor",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "linspace", "is_same_size", "resolve_conj", "resolve_neg",
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias",
    "unfold", "split", "split_with_sizes", "narrow", "diagonal",
    "view_as_real", "view_as_complex", "_reshape_alias", "unbind",
    "movedim", "flatten", "real", "imag", "conj", "_conj", "expand_as",
})

#: reductions priced at input size (JAX's `_REDUCE_PRIMS`)
_REDUCE_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "var", "std", "var_mean", "std_mean", "logsumexp", "any",
    "all", "linalg_vector_norm", "norm", "cumsum", "cumprod", "cummax",
    "cummin", "logcumsumexp", "count_nonzero", "aminmax", "nansum",
})

_MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "addmv",
                         "dot", "vdot", "addbmm"})


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


def _elems(t: torch.Tensor) -> int:
    return t.numel()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _aten_cost(name: str, args, kwargs, out) -> Tuple[float, float]:
    """``(flops, movement_bytes)`` of one aten op, JAX's `_eqn_cost`
    rules on its operands' and results' shapes."""
    outs = _tensors(out)
    out_elems = sum(_elems(t) for t in outs)
    if name in _FREE_OPS:
        return 0.0, 0.0
    if name in _MOVEMENT_OPS:
        ins = _tensors(list(args) + list(kwargs.values()))
        return 0.0, float(sum(_nbytes(t) for t in ins)
                          + sum(_nbytes(t) for t in outs))
    if name in _MATMUL_OPS:
        # the contraction: the first matrix operand's last axis
        mats = [a for a in args if isinstance(a, torch.Tensor)
                and a.dim() >= 1]
        if name in ("addmm", "baddbmm", "addmv", "addbmm"):
            mats = mats[1:]
        contraction = mats[0].shape[-1] if mats else 1
        return 2.0 * out_elems * max(1, int(contraction)), 0.0
    if name in ("convolution", "_convolution", "conv2d", "conv1d"):
        # the weight is (out_ch, in_ch / groups, *kernel)
        weight = args[1]
        spatial = math.prod(weight.shape[2:]) or 1
        return 2.0 * out_elems * spatial * int(weight.shape[1]), 0.0
    if name in ("_fft_r2c", "_fft_c2c", "_fft_c2r"):
        x = args[0]
        dims = list(args[1]) if len(args) > 1 else [x.dim() - 1]
        if name == "_fft_c2r":
            lengths = [int(outs[0].shape[d]) for d in dims]
        else:
            lengths = [int(x.shape[d]) for d in dims]
        n = math.prod(lengths) or 1
        batches = max(1, _elems(x) // max(1, math.prod(
            int(x.shape[d]) for d in dims)))
        return 5.0 * n * math.log2(max(2, n)) * batches, 0.0
    if "pool" in name:
        # a pooling window (JAX's reduce_window): each output element
        # reads its window
        window = args[1] if len(args) > 1 else (1,)
        window = list(window) if isinstance(window, (list, tuple)) \
            else [window]
        if len(window) == 1 and "2d" in name:
            window = window * 2
        return float(out_elems * (math.prod(window) or 1)), 0.0
    if name in _REDUCE_OPS:
        x = next((a for a in args if isinstance(a, torch.Tensor)), None)
        return float(_elems(x) if x is not None else out_elems), 0.0
    if name in ("sort", "topk", "argsort", "msort"):
        x = args[0]
        dim = x.dim() - 1
        for a in args[1:]:
            if isinstance(a, int) and name != "topk":
                dim = a
                break
        n = int(x.shape[dim]) if x.dim() else 2
        return float(_elems(x) * math.log2(max(2, n))), 0.0
    if name.startswith("scatter") or name in ("index_put", "index_put_",
                                              "index_add", "index_add_"):
        updates = _tensors(args[-1])
        target = args[0] if isinstance(args[0], torch.Tensor) else None
        nbytes = (_nbytes(target) if target is not None else 0) \
            + sum(_nbytes(t) for t in outs)
        return float(sum(_elems(t) for t in updates)), float(nbytes)
    # elementwise and everything else: one FLOP an output element
    return float(out_elems), 0.0


class _CostMode(MetaMode):
    """Prices every aten op a body runs on meta tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.movement = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = func.overloadpacket.__name__
        try:
            f, m = _aten_cost(name, args, kwargs, out)
        except Exception:
            f, m = float(sum(_elems(t) for t in _tensors(out))), 0.0
        self.flops += f
        self.movement += m
        return out


class BodyCounts(NamedTuple):
    """Per-item costs of one stage body."""

    flops: float
    movement_bytes: float
    kernel_bytes: float


def traced_body(fn, elem) -> Tuple[Any, Optional[BodyCounts]]:
    """``(out_elem, counts)`` of one stage body run once on meta tensors
    over ``elem`` under `_CostMode`; ``(UNKNOWN, None)`` where the body
    cannot run there (host code)."""
    from ..ops.meta import collect_costs

    if not is_known(elem):
        return UNKNOWN, None
    try:
        with torch.no_grad(), collect_costs() as kern, _CostMode() as mode:
            out = fn(to_meta(elem))
    except Exception:
        return UNKNOWN, None
    return from_meta(out), BodyCounts(mode.flops + kern.flops,
                                      mode.movement, kern.nbytes)


# --------------------------------------------------------------- machine


@dataclass(frozen=True)
class Machine:
    """The roofline's two peak rates. ``balance`` (FLOP per byte) is the
    ridge point: a stage below it is bandwidth-bound."""

    peak_flops: float  # FLOP/s
    peak_bw: float     # B/s

    @property
    def balance(self) -> float:
        return self.peak_flops / self.peak_bw


def default_machine() -> Machine:
    """The calibrated rates every cost decision of the port prices with
    (`calibrate.machine_rates`: the card's measured calibration where it
    names this card, else the published or CPU analytic peaks)."""
    from ..nodes.learning.calibrate import machine_rates

    peak_flops, peak_bw = machine_rates()
    return Machine(peak_flops, peak_bw)


def stage_cost(flops: Optional[float], nbytes: Optional[float],
               machine: Optional[Machine] = None) -> float:
    """``max(flops/peak_flops, bytes/peak_bw)``: the roofline's seconds."""
    machine = machine or default_machine()
    return max(float(flops or 0.0) / machine.peak_flops,
               float(nbytes or 0.0) / machine.peak_bw)


# ------------------------------------------------------------ stage model


@dataclass
class StageRoofline:
    """One priced stage: FLOPs, stage-at-a-time bytes, intensity, bound
    and predicted seconds. ``trail`` holds the internal stages of a fused
    or megafused body."""

    vertex: NodeId
    label: str
    flops: float
    hbm_bytes: int
    movement_bytes: float
    count: int
    flop_source: str  # "traced" | "modeled" | "mixed"
    intensity: float
    bound: str  # "compute" | "bandwidth"
    predicted_seconds: float
    trail: List[Dict[str, Any]] = field(default_factory=list)
    internal_boundary_bytes: int = 0
    kernel_bytes: float = 0.0

    def as_row(self) -> Dict[str, Any]:
        return {
            "vertex": self.vertex.id,
            "label": self.label,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "movement_bytes": self.movement_bytes,
            "kernel_bytes": self.kernel_bytes,
            "count": self.count,
            "flop_source": self.flop_source,
            "intensity": self.intensity,
            "bound": self.bound,
            "predicted_seconds": self.predicted_seconds,
            "stages": list(self.trail),
        }


@dataclass
class RooflineEstimate:
    """The roofline picture of one graph."""

    stages: Dict[NodeId, StageRoofline] = field(default_factory=dict)
    machine: Machine = None
    plan_seconds: float = 0.0
    candidates: List[Dict[str, Any]] = field(default_factory=list)
    unknown_stages: int = 0

    def rows(self, graph: Graph) -> List[Dict[str, Any]]:
        """The priced stages' rows in topological order (`:374-377`)."""
        order, _ = toposort(graph)
        return [self.stages[v].as_row() for v in order
                if isinstance(v, NodeId) and v in self.stages]

    def __repr__(self) -> str:
        return (f"RooflineEstimate({len(self.stages)} stage(s), "
                f"≈{self.plan_seconds:.3e}s predicted, "
                f"{len(self.candidates)} kernel candidate(s))")


def _fmt_rate(x: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(x) < 1000 or unit == "P":
            return f"{x:.1f}{unit}"
        x /= 1000.0
    return str(x)


def format_roofline(rows: List[Dict[str, Any]]) -> str:
    """Text table of `RooflineEstimate.rows` (`:393-409`, the
    ``--explain-roofline`` rendering)."""
    lines = [f"{'stage':<40} {'flops':>10} {'bytes':>10} {'flop/B':>8} "
             f"{'bound':<10} {'pred s':>10}"]
    for r in rows:
        name = f"{r['label']}@{r['vertex']}"
        lines.append(
            f"{name[:40]:<40} {_fmt_rate(r['flops']):>10} "
            f"{_fmt_bytes(int(r['hbm_bytes'])):>10} "
            f"{r['intensity']:>8.2f} {r['bound']:<10} "
            f"{r['predicted_seconds']:>10.3e}")
    return "\n".join(lines)


# --------------------------------------------------------- trail walking


def _elem_count(spec: Any, nominal: int) -> int:
    if isinstance(spec, DataSpec) and spec.kind == "dataset":
        return int(spec.count) if spec.count else nominal
    return 1


def _modeled_dense_flops(in_elem, out_elem) -> Optional[float]:
    """Per-item FLOPs of a fitted apply modeled as a dense map in → out
    (2·in·out, the y = xW family; `:417-447`). Where both sides are one
    2-D leaf sharing the leading dim, the map is row-wise and prices
    2·rows·d_in·d_out."""
    in_leaves = tree_leaves(in_elem)
    out_leaves = tree_leaves(out_elem)
    if len(in_leaves) == 1 and len(out_leaves) == 1:
        a, b = in_leaves[0], out_leaves[0]
        if getattr(a, "ndim", 0) == 2 and getattr(b, "ndim", 0) == 2 \
                and a.shape[0] == b.shape[0]:
            return 2.0 * float(a.shape[0]) * float(a.shape[1]) \
                * float(b.shape[1])

    def elems(e) -> Optional[int]:
        total = 0
        for leaf in tree_leaves(e):
            shape = getattr(leaf, "shape", None)
            if shape is None:
                return None
            total += math.prod(shape)
        return total

    in_elems = elems(in_elem)
    out_elems = elems(out_elem)
    if in_elems is None or out_elems is None:
        return None
    return 2.0 * in_elems * out_elems


def _stage_trail(graph: Graph, vid: NodeId, op, specs: Dict[GraphId, Any]):
    """The per-internal-stage cost trail of one vertex: ``[(label,
    in_elem, out_elem, flops_per_item, movement_per_item,
    kernel_bytes_per_item, source)]``, or None when nothing can be
    priced. A fused or megafused operator (or transformer) walks its
    peepholed stage list with fit slots modeled as dense maps; a
    `DelegatingOperator` is one modeled map; a plain transformer whose
    body runs on meta tensors is one traced stage."""
    from ..nodes.util.fusion import FusedBatchTransformer, _peephole
    from ..workflow.fusion_rule import FusedChainOperator, _FitSlot
    from ..workflow.operators import DelegatingOperator

    deps = graph.get_dependencies(vid)
    if not deps:
        return None

    if isinstance(op, (FusedChainOperator, FusedBatchTransformer)):
        data_spec = specs.get(deps[-1])
        if not isinstance(data_spec, DataSpec) or not is_known(
                data_spec.element):
            return None
        t_specs = [specs.get(d) for d in deps[:-1]]
        elem = data_spec.element
        trail = []
        stage_list = (list(op.stage_specs)
                      if isinstance(op, FusedChainOperator)
                      else list(op.stages))
        # one unpriceable internal stage leaves the whole vertex
        # unpriced: a partial prefix would undercount the plan
        for s in _peephole(stage_list):
            if not is_known(elem):
                return None
            if isinstance(s, _FitSlot):
                ts = t_specs[s.index] if s.index < len(t_specs) else None
                out = (ts.apply_element(elem)
                       if isinstance(ts, TransformerSpec) else UNKNOWN)
                if not is_known(out):
                    return None
                flops = _modeled_dense_flops(elem, out)
                if flops is None:
                    return None
                trail.append((repr(s), elem, out, flops, 0.0, 0.0,
                              "modeled"))
            else:
                out, counts = traced_body(
                    lambda x, s=s: s.single_transform([x]), elem)
                if counts is None or not is_known(out):
                    return None
                trail.append((s.label, elem, out, counts.flops,
                              counts.movement_bytes, counts.kernel_bytes,
                              "traced"))
            elem = trail[-1][2]
        return trail or None

    if isinstance(op, DelegatingOperator):
        if len(deps) < 2:
            return None
        data_spec = specs.get(deps[1])
        out_spec = specs.get(vid)
        if not isinstance(data_spec, DataSpec) \
                or not isinstance(out_spec, DataSpec) \
                or not is_known(data_spec.element) \
                or not is_known(out_spec.element):
            return None
        # the estimator may declare its encoder's flop order
        # (`abstract_apply_flops`); the dense model is the fallback
        flops = None
        est_dep = deps[0]
        if isinstance(est_dep, NodeId):
            hook = getattr(graph.get_operator(est_dep),
                           "abstract_apply_flops", None)
            if hook is not None:
                try:
                    flops = hook(data_spec.element, out_spec.element)
                except Exception:
                    flops = None
        if flops is None:
            flops = _modeled_dense_flops(data_spec.element,
                                         out_spec.element)
        if flops is None:
            return None
        return [(_label(graph, vid), data_spec.element, out_spec.element,
                 float(flops), 0.0, 0.0, "modeled")]

    fn = getattr(op, "single_transform", None)
    if fn is None:
        return None
    data_spec = specs.get(deps[0])
    if not isinstance(data_spec, DataSpec) or not is_known(
            data_spec.element):
        return None
    _, counts = traced_body(lambda x: fn([x]), data_spec.element)
    out_spec = specs.get(vid)
    out_elem = out_spec.element if isinstance(out_spec, DataSpec) else UNKNOWN
    if counts is None or not is_known(out_elem):
        return None
    return [(_label(graph, vid), data_spec.element, out_elem,
             counts.flops, counts.movement_bytes, counts.kernel_bytes,
             "traced")]


# ------------------------------------------------------------------ pass


def roofline_pass(
    graph: Graph,
    specs: Dict[GraphId, Any],
    *,
    machine: Optional[Machine] = None,
    chunk_rows: Optional[int] = None,
    only: Optional[Sequence[NodeId]] = None,
) -> Tuple[RooflineEstimate, List[Diagnostic]]:
    """Price every priceable stage of one graph and emit the KP8xx lints.
    No data moves and nothing launches. ``only`` restricts pricing to the
    given vertices (and skips the whole-plan lints)."""
    from ..workflow.fusion_rule import MegafusedPlanOperator

    machine = machine or default_machine()
    chunk_rows = resolve_chunk_rows(chunk_rows)
    order, _ = toposort(graph)
    restrict = set(only) if only is not None else None
    est = RooflineEstimate(machine=machine)
    diags: List[Diagnostic] = []

    known_counts = [
        s.count for s in specs.values()
        if isinstance(s, DataSpec) and s.kind == "dataset" and s.count
    ]
    nominal = max(known_counts, default=1024)

    for vid in order:
        if not isinstance(vid, NodeId):
            continue
        if restrict is not None and vid not in restrict:
            continue
        op = graph.get_operator(vid)
        out_spec = specs.get(vid)
        if not isinstance(out_spec, DataSpec):
            continue  # estimators, transformer outputs: no data stage
        try:
            trail = _stage_trail(graph, vid, op, specs)
        except Exception:
            trail = None
        if not trail:
            if graph.get_dependencies(vid):
                est.unknown_stages += 1
            continue
        count = _elem_count(out_spec, nominal)

        flops = movement = kernel_bytes = 0.0
        hbm = internal = 0
        trail_rows: List[Dict[str, Any]] = []
        sources = set()
        priced = True
        for i, (label, in_elem, out_elem, f_item, m_item, k_item,
                source) in enumerate(trail):
            in_b = element_nbytes(in_elem)
            out_b = element_nbytes(out_elem)
            if in_b is None or out_b is None:
                priced = False
                break
            s_flops = f_item * count
            s_bytes = (in_b + out_b) * count
            s_move = m_item * count
            s_int = s_flops / s_bytes if s_bytes else 0.0
            s_bound = ("compute" if s_int >= machine.balance
                       else "bandwidth")
            trail_rows.append({
                "stage": label,
                "flops": s_flops,
                "hbm_bytes": s_bytes,
                "movement_bytes": s_move,
                "kernel_bytes": k_item * count,
                "intensity": s_int,
                "bound": s_bound,
                "predicted_seconds": stage_cost(s_flops, s_bytes, machine),
                "flop_source": source,
            })
            flops += s_flops
            movement += s_move
            kernel_bytes += k_item * count
            hbm += s_bytes
            if i < len(trail) - 1:
                internal += out_b * count
            sources.add(source)
        if not priced or not hbm:
            est.unknown_stages += 1
            continue

        intensity = flops / hbm
        bound = "compute" if intensity >= machine.balance else "bandwidth"
        est.stages[vid] = st = StageRoofline(
            vertex=vid,
            label=_label(graph, vid),
            flops=flops,
            hbm_bytes=hbm,
            movement_bytes=movement,
            count=count,
            flop_source=(sources.pop() if len(sources) == 1 else "mixed"),
            intensity=intensity,
            bound=bound,
            predicted_seconds=stage_cost(flops, hbm, machine),
            trail=trail_rows if len(trail_rows) > 1 else [],
            internal_boundary_bytes=internal,
            kernel_bytes=kernel_bytes,
        )
        if restrict is not None:
            continue

        # KP802: pure layout traffic at least the larger of the stage's
        # compute and its unavoidable boundary bytes
        if st.movement_bytes > max(st.flops, float(st.hbm_bytes)):
            diags.append(Diagnostic(
                "KP802", Severity.WARNING,
                f"data-movement-dominated stage: "
                f"{_fmt_bytes(int(st.movement_bytes))} of pure "
                f"copy/view/index traffic vs {_fmt_rate(st.flops)} FLOPs "
                f"over {_fmt_bytes(st.hbm_bytes)} of boundary bytes — "
                "the stage pays for layout, not math",
                vertex=vid, label=st.label))

        # KP804: a megafused loop whose trip is under the dispatch floor
        if isinstance(op, MegafusedPlanOperator) and count:
            trip_cost = stage_cost(flops / count * chunk_rows,
                                   hbm / count * chunk_rows, machine)
            if trip_cost < DISPATCH_OVERHEAD_S:
                diags.append(Diagnostic(
                    "KP804", Severity.INFO,
                    f"megafused loop body predicts ≈{trip_cost:.1e}s a "
                    f"trip (chunk_rows={chunk_rows}) — below the "
                    f"≈{DISPATCH_OVERHEAD_S:.0e}s dispatch/loop overhead "
                    "floor; raise chunk_size so each trip amortizes its "
                    "bookkeeping",
                    vertex=vid, label=st.label))

    est.plan_seconds = sum(s.predicted_seconds for s in est.stages.values())
    if restrict is not None:
        return est, diags

    # ----------------------------------------------------------- KP801
    est.candidates = _kernel_candidates(graph, est, machine)
    for cand in est.candidates:
        head = cand["vertices"][0]
        diags.append(Diagnostic(
            "KP801", Severity.INFO,
            f"kernel-candidate: bandwidth-bound fan-out-free chain of "
            f"{cand['n_stages']} stage(s) [{' >> '.join(cand['stages'])}]; "
            f"one kernel keeps {_fmt_bytes(cand['boundary_bytes'])} of "
            f"boundary round-trips on chip (≈{cand['seconds_saved']:.2e}s "
            f"at {_fmt_rate(machine.peak_bw)}B/s)",
            vertex=head, label=_label(graph, head)))
        verdict = cand.get("lowerable") or {}
        if verdict.get("lowerable") \
                and cand["kernel_seconds"] < cand["chain_seconds"]:
            diags.append(Diagnostic(
                "KP805", Severity.INFO,
                f"chain-kernel-wins: lowers to ONE {verdict['family']} "
                f"kernel launch (ops/chain_kernels) — predicted "
                f"≈{cand['kernel_seconds']:.2e}s vs the stage-at-a-time "
                f"chain's ≈{cand['chain_seconds']:.2e}s",
                vertex=head, label=_label(graph, head)))

    if est.stages:
        diags.append(Diagnostic(
            "KP803", Severity.INFO,
            f"plan roofline: ≈{est.plan_seconds:.3e}s predicted over "
            f"{len(est.stages)} priced stage(s) (machine balance "
            f"{machine.balance:.1f} FLOP/B; peaks "
            f"{_fmt_rate(machine.peak_flops)}FLOP/s, "
            f"{_fmt_rate(machine.peak_bw)}B/s)"
            + (f"; {est.unknown_stages} stage(s) unpriced"
               if est.unknown_stages else ""),
            vertex=None, label="<plan>"))
    return est, diags


def _fusable_member(graph: Graph, vid: NodeId) -> bool:
    from ..workflow.fusion_rule import FusedChainOperator

    op = graph.get_operator(vid)
    return bool(getattr(op, "fusable", False)) \
        or isinstance(op, FusedChainOperator)


def _kernel_candidates(graph: Graph, est: RooflineEstimate,
                       machine: Machine) -> List[Dict[str, Any]]:
    """KP801 chains (JAX's `_pallas_candidates`, `:760-870`): maximal
    fan-out-free runs of ≥ 2 adjacent priced bandwidth-bound fusable
    stages, and runs of ≥ 2 consecutive bandwidth-bound trail stages
    inside one fused operator, each priced with the boundary bytes one
    kernel would keep on chip (every internal boundary one write and one
    read at peak bandwidth)."""
    out: List[Dict[str, Any]] = []
    order, _ = toposort(graph)

    def bandwidth_bound(v) -> bool:
        s = est.stages.get(v)
        return s is not None and s.bound == "bandwidth"

    visited: set = set()
    for vid in order:
        if not isinstance(vid, NodeId) or vid in visited:
            continue
        if not (bandwidth_bound(vid) and _fusable_member(graph, vid)):
            continue
        chain = [vid]
        cur = vid
        while True:
            users = [u for u in graph.users_of(cur)
                     if not isinstance(u, SinkId)]
            if len(users) != 1 or not isinstance(users[0], NodeId):
                break
            nxt = users[0]
            if nxt in visited or not (
                    bandwidth_bound(nxt) and _fusable_member(graph, nxt)):
                break
            chain.append(nxt)
            cur = nxt
        visited.update(chain)
        if len(chain) < 2:
            continue
        boundary = sum(_chain_boundary_bytes(est, v) for v in chain[:-1])
        cand = {
            "vertices": list(chain),
            "stages": [est.stages[v].label for v in chain],
            "n_stages": len(chain),
            "boundary_bytes": int(boundary),
            "seconds_saved": 2.0 * boundary / machine.peak_bw,
            "chain_seconds": sum(est.stages[v].predicted_seconds
                                 for v in chain),
            "chain_flops": sum(est.stages[v].flops for v in chain),
            "chain_hbm_bytes": int(sum(est.stages[v].hbm_bytes
                                       for v in chain)),
            "stage_slice": None,
            "kind": "graph_chain",
        }
        _annotate_kernel_lowering(graph, cand, machine)
        out.append(cand)

    for vid, st in est.stages.items():
        if len(st.trail) < 2:
            continue
        i = 0
        while i < len(st.trail):
            if st.trail[i]["bound"] != "bandwidth":
                i += 1
                continue
            j = i
            while j < len(st.trail) and st.trail[j]["bound"] == "bandwidth":
                j += 1
            if j - i >= 2:
                boundary = sum(int(min(st.trail[k]["hbm_bytes"],
                                       st.trail[k + 1]["hbm_bytes"]) // 2)
                               for k in range(i, j - 1))
                cand = {
                    "vertices": [vid],
                    "stages": [st.trail[k]["stage"] for k in range(i, j)],
                    "n_stages": j - i,
                    "boundary_bytes": int(boundary),
                    "seconds_saved": 2.0 * boundary / machine.peak_bw,
                    "chain_seconds": sum(st.trail[k]["predicted_seconds"]
                                         for k in range(i, j)),
                    "chain_flops": sum(st.trail[k]["flops"]
                                       for k in range(i, j)),
                    "chain_hbm_bytes": int(sum(st.trail[k]["hbm_bytes"]
                                               for k in range(i, j))),
                    "stage_slice": (i, j),
                    "kind": "fused_trail",
                }
                _annotate_kernel_lowering(graph, cand, machine)
                out.append(cand)
            i = j
    return out


def _candidate_stage_objects(graph: Graph, cand: Dict[str, Any]):
    """The stage objects a KP801 candidate's kernel would replace, or
    None where the chain has a fit slot (no static body before the
    fit)."""
    from ..nodes.util.fusion import FusedBatchTransformer, _peephole
    from ..workflow.fusion_rule import FusedChainOperator, _FitSlot

    stages: List[Any] = []
    if cand["kind"] == "fused_trail":
        op = graph.get_operator(cand["vertices"][0])
        stage_list = (list(op.stage_specs)
                      if isinstance(op, FusedChainOperator)
                      else list(op.stages))
        i, j = cand["stage_slice"]
        stages = list(_peephole(stage_list))[i:j]
    else:
        for vid in cand["vertices"]:
            op = graph.get_operator(vid)
            if isinstance(op, (FusedChainOperator, FusedBatchTransformer)):
                stages.extend(op.stage_specs
                              if isinstance(op, FusedChainOperator)
                              else op.stages)
            else:
                stages.append(op)
    # a stage without ``fuse`` gets its key from `stage_fuse` (an opaque
    # one, or the peephole's kernel stage)
    if any(isinstance(s, _FitSlot) for s in stages) \
            or not all(getattr(s, "fusable", False) for s in stages):
        return None
    return stages


def _annotate_kernel_lowering(graph: Graph, cand: Dict[str, Any],
                              machine: Machine) -> None:
    """The chain-kernel verdict of one KP801 candidate
    (`ops/chain_kernels.py::lowerability` on its stages' statics) and,
    where it lowers, ``kernel_seconds``: one pass over device memory of
    the chain's input and output bytes at the same rates; INF where it
    does not lower."""
    try:
        from ..nodes.util.fusion import stage_statics
        from ..ops.chain_kernels import lowerability

        stages = _candidate_stage_objects(graph, cand)
        if stages is None:
            verdict = {"lowerable": False, "family": None,
                       "reason": "fit-dependent stage: no static fuse "
                                 "body to lower"}
        else:
            verdict = lowerability(stage_statics(stages))
    except Exception as e:  # the verdict never breaks the pass
        verdict = {"lowerable": False, "family": None,
                   "reason": f"fuse decomposition failed: {e}"}
    cand["lowerable"] = verdict
    if verdict.get("lowerable"):
        kernel_bytes = max(
            float(cand["chain_hbm_bytes"] - 2 * cand["boundary_bytes"]),
            0.0)
        cand["kernel_seconds"] = stage_cost(cand["chain_flops"],
                                            kernel_bytes, machine)
    else:
        cand["kernel_seconds"] = float("inf")


def _chain_boundary_bytes(est: RooflineEstimate, vid: NodeId) -> int:
    """The boundary a graph-chain member hands its consumer: half its
    stage traffic (exact where input and output bytes are equal)."""
    st = est.stages[vid]
    if st.trail:
        return int(st.trail[-1]["hbm_bytes"] // 2)
    return int(st.hbm_bytes // 2)


# --------------------------------------------------- optimizer plumbing


def chain_predicted_seconds(graph: Graph,
                            vertices: Sequence[NodeId]) -> Optional[float]:
    """Roofline seconds of one chain of vertices on a bound graph
    (`:959-977`): the ``predicted_seconds`` a fusion or megafusion
    ledger record carries. None where nothing in the chain can be priced
    (unbound sources, host bodies). Never raises."""
    try:
        from .propagate import spec_pass

        specs, _ = spec_pass(graph, {})
        # only the chain's vertices: a pass over every stage of the
        # graph for each record would trace each stage once a chain
        est, _ = roofline_pass(graph, specs, only=list(vertices))
        vals = [est.stages[v].predicted_seconds for v in vertices
                if v in est.stages]
        return float(sum(vals)) if vals else None
    except Exception:
        return None
