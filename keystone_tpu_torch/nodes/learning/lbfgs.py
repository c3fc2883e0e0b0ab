"""L-BFGS least squares with L2, on dense and on sparse features.

Counterpart of `keystone_tpu/nodes/learning/lbfgs.py`: the centring pass
`_lbfgs_prepare` (`:88-107`), the zero start `_lbfgs_init` (`:110-113`),
the step `_lbfgs_step` (`:116-136`) and `DenseLBFGSwithL2` (`:139-207`);
reference nodes/learning/LBFGS.scala:14-281. The objective is the
unnormalized ½‖Xc W − Yc‖² + ½λ‖W‖² (`:58-64`), Xc and Yc centred by the
row count and masked.

The JAX package steps with `optax.lbfgs(memory_size)`, whose defaults in
optax 0.2.6 are the two-loop recursion of `scale_by_lbfgs` with a scaled
initial preconditioner (`optax/_src/transform.py:1497-1750`), a step of
−1, and `scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")` (`optax/_src/linesearch.py:576-1450`).
`torch.optim.LBFGS` searches and scales otherwise, so its iterates
differ; this module keeps its own copy of optax's algorithm,
`lbfgs_minimize`, apart from the objective it minimizes (the ridge
`_Objective` here, the softmax one in `classifiers.py`):

- the model, gradients, the history ring buffers and every inner
  product of the two-loop recursion stay on the device;
- the zoom search's decisions are float32 scalar arithmetic on the host,
  as optax makes them in float32. Each function evaluation on the line
  sends its value and slope to the host in one transfer (the search's
  first also carries the slope at step 0, and the fit's first the
  starting value): those transfers are the fit's synchronizing calls,
  one per evaluation, all at `_evaluate`.

`SparseLBFGSwithL2` (`:507-827`, with `_lbfgs_gram_fit` `:210-237`,
`_sparse_matvec_fit_impl` `:240-452` and the Gram reduction `:829-949`)
fits sparse rows by one of two routes, its docstring says which and why.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ...data.dataset import Dataset
from ...data.sparse import PaddedSparseDataset, SparseDataset, memory_budget
from ...telemetry.instrument import record_dispatch
from ...telemetry.metrics import counter
from ...telemetry.spans import span
from ...workflow.pipeline import LabelEstimator
from . import cost_model
from .linear import LinearMapper, SparseLinearMapper

_STEPS = counter("solver.steps")

f32 = np.float32

# optax's zoom line search as `optax.lbfgs` configures it
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = f32(2.0)
SLOPE_RTOL = f32(1e-4)
APPROX_SLOPE = f32(2 * 1e-4 - 1.0)
CURV_RTOL = f32(0.9)
APPROX_DEC_RTOL = f32(1e-6)
INTERVAL_THRESHOLD = f32(1e-5)
TOL = f32(0.0)


def lbfgs_prepare(X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
                  count: int, fit_intercept: bool):
    """(Xc, Yc, xm, ym): the masked rows, centred by ``count`` when
    ``fit_intercept`` (xm, ym zeros otherwise)."""
    m = mask.to(X.dtype)[:, None]
    Y = Y.to(X.dtype)
    if fit_intercept:
        xm = X.sum(dim=0) / count
        ym = Y.sum(dim=0) / count
        return (X - xm).mul_(m), (Y - ym).mul_(m), xm, ym
    xm = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    ym = torch.zeros(Y.shape[1], dtype=X.dtype, device=X.device)
    return X * m, Y * m, xm, ym


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


class _Objective:
    """½‖Xc W − Yc‖² + ½λ‖W‖² and its gradient Xcᵀ(Xc W − Yc) + λW."""

    def __init__(self, Xc: torch.Tensor, Yc: torch.Tensor, lam: float):
        self.Xc, self.Yc, self.lam = Xc, Yc, lam

    def __call__(self, W: torch.Tensor):
        resid = self.Xc @ W - self.Yc
        value = 0.5 * _dot(resid, resid) + 0.5 * self.lam * _dot(W, W)
        grad = torch.addmm(W, self.Xc.T, resid, beta=self.lam)
        return value, grad


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """optax's sufficient-decrease error, with its approximate form."""
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - APPROX_SLOPE * slope_init
    delta = value - value_init - APPROX_DEC_RTOL * abs(value_init)
    err = np.maximum(np.minimum(np.maximum(approx, delta), err), f32(0.0))
    return f32(np.inf) if np.isnan(err) else f32(err)


def _curvature_error(slope, slope_init):
    err = np.maximum(abs(slope) - CURV_RTOL * abs(slope_init), f32(0.0))
    return f32(np.inf) if np.isnan(err) else f32(err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * v0 - db ** 2 * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - f32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (f32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa, fpa), (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (f32(2.0) * B)


@dataclass
class _Point:
    """A point on the line: step size, value, slope (host float32) and
    gradient (device)."""

    stepsize: np.float32
    value: np.float32
    slope: np.float32
    grad: torch.Tensor


def _evaluate(objective, W, u, stepsize, extra=()):
    """The objective at W + stepsize·u: (``extra``, then the value and
    the slope along u, on the host as float32 in one transfer; the
    gradient there)."""
    value, grad = objective(W + u * float(stepsize))
    host = torch.stack([*extra, value, _dot(grad, u)]).cpu().numpy()
    return host, grad


def zoom_linesearch(objective, W, u, value_init, grad, value_pending=None):
    """optax's zoom line search from W along the descent direction u,
    with the step guess 1: (accepted point, evaluations, value at W).
    ``value_init`` is the host value at W, or None with
    ``value_pending``, a device 0-d tensor, in its place; it and the
    slope at W travel with the first evaluation."""
    extra = [_dot(u, grad)] + ([] if value_pending is None
                               else [value_pending])
    with np.errstate(all="ignore"):
        host, g = _evaluate(objective, W, u, f32(1.0), extra)
        if value_pending is not None:
            value_init = f32(host[1])
        start = _Point(f32(0.0), f32(value_init), f32(host[0]), grad)
        first = _Point(f32(1.0), f32(host[-2]), f32(host[-1]), g)
        point, count = _zoom(objective, W, u, start, first)
    return point, count, start.value


def _zoom(objective, W, u, start: _Point, first: _Point):
    """optax's `zoom_linesearch` step loop (`linesearch.py:576-1282`)
    from ``start`` (step 0), whose first evaluation is ``first``."""
    value_init, slope_init = start.value, start.slope
    cur = low = high = cubic = start  # cubic: the interpolation's third
    safe = start        # the best point with sufficient decrease so far
    interval_found = done = failed = False
    count = 0
    while not (done or failed):
        if not interval_found:
            # widen: the step doubles until [low, high] holds a minimizer
            if count == 0:
                new = first
            else:
                step = INCREASE_FACTOR * cur.stepsize
                host, g = _evaluate(objective, W, u, step)
                new = _Point(step, f32(host[0]), f32(host[1]), g)
            decrease = _decrease_error(new.stepsize, new.value, new.slope,
                                       value_init, slope_init)
            error = np.maximum(decrease,
                               _curvature_error(new.slope, slope_init))
            if decrease <= TOL:
                safe = new
            high_to_new = bool(decrease > 0.0) or bool(
                new.value >= cur.value and count > 0)
            low_to_new = bool(new.slope >= 0.0) and not high_to_new
            low, high = (new, cur) if low_to_new else (cur, new)
            interval_found = high_to_new or low_to_new or bool(error <= TOL)
            done = bool(error <= TOL)
            failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
            cubic = low
        else:
            # zoom: the cubic's minimizer, else the quadratic's, else the
            # midpoint, inside [low, high]
            delta = abs(high.stepsize - low.stepsize)
            left = np.minimum(high.stepsize, low.stepsize)
            right = np.maximum(high.stepsize, low.stepsize)
            mc = _cubicmin(low.stepsize, low.value, low.slope, high.stepsize,
                           high.value, cubic.stepsize, cubic.value)
            mq = _quadmin(low.stepsize, low.value, low.slope, high.stepsize,
                          high.value)
            if left + f32(0.2) * delta < mc < right - f32(0.2) * delta:
                step = mc
            elif left + f32(0.1) * delta < mq < right - f32(0.1) * delta:
                step = mq
            else:
                step = (low.stepsize + high.stepsize) / f32(2.0)
            step = f32(step)
            host, g = _evaluate(objective, W, u, step)
            new = _Point(step, f32(host[0]), f32(host[1]), g)
            decrease = _decrease_error(new.stepsize, new.value, new.slope,
                                       value_init, slope_init)
            error = np.maximum(decrease,
                               _curvature_error(new.slope, slope_init))
            if decrease <= TOL and new.value < safe.value:
                safe = new
            done = bool(error <= TOL)
            high_to_mid = bool(decrease > 0.0) or bool(
                new.value >= low.value)
            high_to_low = bool(new.slope * (high.stepsize - low.stepsize)
                               >= 0.0) and not high_to_mid
            cubic = high if (high_to_mid or high_to_low) else low
            if high_to_low:
                high = low
            elif high_to_mid:
                high = new
            if not high_to_mid:
                low = new
            failed = (count + 1 >= MAX_LINESEARCH_STEPS or bool(
                delta <= INTERVAL_THRESHOLD and safe.stepsize > 0.0)) \
                and not done
        cur = new
        count += 1
        if failed and (safe.stepsize > 0.0 or np.isinf(decrease)):
            cur = safe  # the safe step (`_try_safe_step`)
    return cur, count


@dataclass
class LBFGSResult:
    """A fit's model (W, and b or None), the objective's value at the
    start of each step, and each step's line-search evaluations."""

    W: torch.Tensor
    b: Optional[torch.Tensor]
    loss_history: List[float]
    linesearch_steps: List[int]


def lbfgs_minimize(objective, W: torch.Tensor, num_iters: int,
                   memory_size: int = 10):
    """``num_iters`` steps of optax's L-BFGS from ``W`` on
    ``objective``, a callable W → (value, gradient) of device tensors:
    (final W, the objective's value at the start of each step, each
    step's line-search evaluations). No step stops early, as JAX's
    `lax.scan` over ``optax.lbfgs`` does not."""
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    # the history ring: slot (k − 1) mod m holds step k's differences
    dws = [None] * memory_size
    dus = [None] * memory_size
    rhos = [None] * memory_size
    prev_W = prev_grad = value = None
    history, steps = [], []
    for k in range(num_iters):
        with span("lbfgs_step", cat="step", iter=k):
            pending = None
            if value is None or not np.isfinite(value):
                pending, grad = objective(W)
                value = None
            if k > 0:
                dw, du = W - prev_W, grad - prev_grad
                vd = _dot(du, dw)
                slot = (k - 1) % memory_size
                dws[slot], dus[slot] = dw, du
                rhos[slot] = torch.where(vd == 0.0, 0.0, 1.0 / vd)
                den = _dot(du, du)
                scale = torch.where(den > 0.0, vd / den, 1.0)
            else:
                # the first step: a capped reciprocal of the gradient's norm
                scale = torch.clamp_max(1.0 / torch.sqrt(_dot(grad, grad)), 1.0)
            # two-loop recursion over the filled slots, newest first (empty
            # slots, zeros in optax's buffers, change nothing)
            order = [i for i in ((k + j) % memory_size
                                 for j in range(memory_size))
                     if dws[i] is not None]
            vec, alphas = grad, {}
            for i in reversed(order):
                alphas[i] = rhos[i] * _dot(dws[i], vec)
                vec = vec - alphas[i] * dus[i]
            vec = scale * vec
            for i in order:
                beta = rhos[i] * _dot(dus[i], vec)
                vec = vec + (alphas[i] - beta) * dws[i]
            u = -vec
            point, evals, start_value = zoom_linesearch(objective, W, u, value,
                                                        grad, pending)
            history.append(float(start_value))
            steps.append(evals)
            prev_W, prev_grad = W, grad
            W = W + u * float(point.stepsize)
            value, grad = point.value, point.grad
        _STEPS.inc()
        record_dispatch()
    return W, history, steps


def lbfgs_fit(X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
              lam: float, count: int, num_iters: int, memory_size: int,
              fit_intercept: bool) -> LBFGSResult:
    """``num_iters`` steps of optax's L-BFGS on the ridge objective from
    W = 0 (`_lbfgs_fit_impl`, `:41-85`)."""
    Xc, Yc, xm, ym = lbfgs_prepare(X, Y, mask, count, fit_intercept)
    W0 = torch.zeros((X.shape[1], Yc.shape[1]), dtype=X.dtype,
                     device=X.device)
    W, history, steps = lbfgs_minimize(_Objective(Xc, Yc, lam), W0,
                                       num_iters, memory_size)
    b = ym - xm @ W if fit_intercept else None
    return LBFGSResult(W, b, history, steps)


class DenseLBFGSwithL2(LabelEstimator):
    """Least squares with L2 by L-BFGS on dense features (LBFGS.scala
    `DenseLBFGSwithL2`). After a fit, ``loss_history`` holds the
    objective at the start of each step and ``linesearch_steps`` each
    step's evaluations."""

    def __init__(self, lam: float = 0.0, num_iters: int = 20,
                 memory_size: int = 10, fit_intercept: bool = True):
        self.lam = lam
        self.num_iters = num_iters
        self.memory_size = memory_size
        self.fit_intercept = fit_intercept
        self.loss_history: Optional[torch.Tensor] = None
        self.linesearch_steps: List[int] = []

    def fit(self, data, labels) -> LinearMapper:
        res = lbfgs_fit(data.array, labels.array, data.mask, self.lam,
                        data.count, self.num_iters, self.memory_size,
                        self.fit_intercept)
        self.loss_history = torch.tensor(res.loss_history,
                                         dtype=torch.float32)
        self.linesearch_steps = res.linesearch_steps
        return LinearMapper(res.W, res.b)


# --------------------------------------------------------------------------
# Sparse features: SparseLBFGSwithL2


#: a densified row block's share of device memory: the share JAX's
#: block cap takes of its 16 GB chip (`:621-622`, `:931-933`)
GRAM_BLOCK_SHARE = 1.0 / 32.0


@contextmanager
def _tf32(enabled: bool):
    """cuBLAS's TF32 mode for float32 products while open."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _accumulate(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                precision: str) -> None:
    """acc += aᵀb at ``precision``: "highest" true float32, "high" TF32,
    "default" bfloat16 operands (the block's product rounded to bfloat16
    before it is added)."""
    if precision == "default":
        acc += (a.T.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
        return
    with _tf32(precision == "high"):
        acc.addmm_(a.T, b)


def gram_statistics(blocks, d: int, k: int, precision: str,
                    device: torch.device):
    """(G = XᵀX, C = XᵀY, column sums of X) over ``blocks``, an iterable
    of (dense row block of X, its rows of Y) (`_sparse_gram_accumulate`,
    `:829-907`)."""
    G = torch.zeros((d, d), dtype=torch.float32, device=device)
    C = torch.zeros((d, k), dtype=torch.float32, device=device)
    colsum = torch.zeros(d, dtype=torch.float32, device=device)
    for Xb, Yb in blocks:
        _accumulate(G, Xb, Xb, precision)
        _accumulate(C, Xb, Yb, precision)
        colsum += Xb.sum(dim=0)
    return G, C, colsum


def gram_row_block(d: int, block_rows: int, device: torch.device) -> int:
    """Rows of a densified block: at most `GRAM_BLOCK_SHARE` of the
    device's memory as float32 (d + 1) columns, and ``block_rows``."""
    cap = int(GRAM_BLOCK_SHARE * memory_budget(device) / (4 * (d + 1)))
    return max(1, min(block_rows, cap))


def csr_row_blocks(data: SparseDataset, Y: torch.Tensor, row_block: int):
    """The CSR's rows densified on its device a block at a time, each
    with its rows of ``Y``. The block bounds come from the host's row
    pointers, so no block waits for the device."""
    X = data.csr()
    cols, vals = X.col_indices(), X.values()
    crow = X.crow_indices()
    indptr = data.matrix.indptr
    n, d, dev = data.count, data.dim, vals.device
    for s in range(0, n, row_block):
        e = min(n, s + row_block)
        a, b = int(indptr[s]), int(indptr[e])
        rows = torch.repeat_interleave(
            torch.arange(e - s, device=dev), crow[s + 1:e + 1] - crow[s:e],
            output_size=b - a)
        dense = torch.zeros((e - s, d), dtype=torch.float32, device=dev)
        dense.index_put_((rows, cols[a:b].long()), vals[a:b],
                         accumulate=True)
        yield dense, Y[s:e]


def padded_row_blocks(data: PaddedSparseDataset, Y: torch.Tensor,
                      row_block: int):
    """Padded rows densified a block at a time (the sentinel column
    dropped), each with its rows of ``Y``."""
    n, d = data.count, data.dim
    for s in range(0, n, row_block):
        e = min(n, s + row_block)
        dense = torch.zeros((e - s, d + 1), dtype=torch.float32,
                            device=data.val.device)
        dense.scatter_add_(1, data.idx[s:e].long(), data.val[s:e])
        yield dense[:, :d], Y[s:e]


class _GramObjective:
    """½ tr(WᵀGW) − tr(WᵀC) + ½λ‖W‖² and its gradient GW − C + λW: the
    ridge objective with n dropped out (`_lbfgs_gram_fit`, `:210-237`)."""

    def __init__(self, G: torch.Tensor, C: torch.Tensor, lam: float):
        self.G, self.C, self.lam = G, C, lam

    def __call__(self, W: torch.Tensor):
        GW = self.G @ W
        value = (0.5 * _dot(W, GW) - _dot(W, self.C)
                 + 0.5 * self.lam * _dot(W, W))
        return value, GW - self.C + self.lam * W


def lbfgs_gram_fit(G: torch.Tensor, C: torch.Tensor, lam: float,
                   num_iters: int, memory_size: int):
    """optax's L-BFGS on the Gram objective from W = 0: (W, the value at
    the start of each step)."""
    W0 = torch.zeros_like(C)
    W, history, _ = lbfgs_minimize(_GramObjective(G, C, lam), W0,
                                   num_iters, memory_size)
    return W, history


def sparse_matvec_fit(X: torch.Tensor, Xt: torch.Tensor, Y: torch.Tensor,
                      lam: float, count: int, d: int, num_iters: int,
                      memory_size: int, fit_intercept: bool):
    """L-BFGS by sparse products (`_sparse_matvec_fit_impl`,
    `:240-452`): (W (d, k), b (k,), the objective after each step).

    ``X`` is the (n, d) CSR of the rows and ``Xt`` the (d, n) CSR of Xᵀ,
    each perhaps with one more column, a sentinel whose entries are 0.
    Each iteration runs two products with X and one with Xᵀ. The
    centring is algebraic, Xc V = XV − 1(x̄ᵀV), so no centred copy
    exists; the objective is quadratic, so the line search is its
    closed form t* = −(⟨R, XcD⟩ + λ⟨W, D⟩)/(‖XcD‖² + λ‖D‖²); the
    two-loop recursion runs over all ``memory_size`` slots of the
    history ring, empty slots zero, as JAX's does. Nothing waits for the
    device until the history is read."""
    n, k = Y.shape
    m = memory_size
    dev = Y.device

    def pad(A, cols):
        return A if A.shape[0] == cols else torch.cat(
            [A, A.new_zeros((cols - A.shape[0], A.shape[1]))])

    def matvec(V):
        return X @ pad(V, X.shape[1])

    def tmatvec(R):
        return Xt @ pad(R, Xt.shape[1])

    if fit_intercept:
        ones = torch.ones((Xt.shape[1], 1), dtype=torch.float32, device=dev)
        xm = (Xt @ ones)[:, 0] / count
        ym = Y.sum(dim=0) / count
    else:
        xm = torch.zeros(d, dtype=torch.float32, device=dev)
        ym = torch.zeros(k, dtype=torch.float32, device=dev)

    def centered_matvec(V):
        return matvec(V) - (xm @ V)[None, :]

    def grad_of(W, R):
        return tmatvec(R) - torch.outer(xm, R.sum(dim=0)) + lam * W

    W = torch.zeros((d, k), dtype=torch.float32, device=dev)
    R = -(Y - ym)
    g = grad_of(W, R)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    S = [torch.zeros_like(W) for _ in range(m)]
    YH = [torch.zeros_like(W) for _ in range(m)]
    rho = [zero] * m
    values = []
    for it in range(num_iters):
        with span("lbfgs_step", cat="step", iter=it):
            ptr = it % m
            q, alphas = g, []
            for j in range(m):
                i = (ptr - 1 - j) % m
                a = rho[i] * _dot(S[i], q)
                q = q - a * YH[i]
                alphas.append((i, a))
            last = (ptr - 1) % m
            yy = _dot(YH[last], YH[last])
            sy = _dot(S[last], YH[last])
            gamma = torch.where(yy > 0, sy / torch.clamp_min(yy, 1e-30), 1.0)
            r = gamma * q
            for i, a in reversed(alphas):
                r = r + S[i] * (a - rho[i] * _dot(YH[i], r))
            D = -r
            u = centered_matvec(D)
            den = _dot(u, u) + lam * _dot(D, D)
            num = -(_dot(R, u) + lam * _dot(W, D))
            t = torch.where(den > 0, num / torch.clamp_min(den, 1e-30), 0.0)
            W = W + t * D
            R = R + t * u
            g_new = grad_of(W, R)
            s_vec, y_vec = t * D, g_new - g
            sy_new = _dot(s_vec, y_vec)
            ok = sy_new > 1e-10
            S[ptr] = torch.where(ok, s_vec, 0.0)
            YH[ptr] = torch.where(ok, y_vec, 0.0)
            rho[ptr] = torch.where(ok, 1.0 / torch.where(ok, sy_new, 1.0), 0.0)
            g = g_new
            values.append(0.5 * _dot(R, R) + 0.5 * lam * _dot(W, W))
        _STEPS.inc()
        record_dispatch()
    b = ym - xm @ W if fit_intercept else torch.zeros(
        k, dtype=torch.float32, device=dev)
    history = torch.stack(values) if values else zero.new_zeros(0)
    return W, b, history


def _labels(labels, count: int, device: torch.device) -> torch.Tensor:
    """Row-major (count, k) float32 labels on ``device`` from a `Dataset`
    or an array, row-major or label-major (k, count) (`:711-728`);
    row-major wins where k == count."""
    if isinstance(labels, Dataset):
        Y = labels.array
    else:
        Y = torch.as_tensor(np.asarray(labels) if not isinstance(
            labels, torch.Tensor) else labels)
        if Y.shape[0] != count and Y.ndim == 2 and Y.shape[1] == count:
            Y = Y.T
    return Y[:count].to(device=device, dtype=torch.float32)


class SparseLBFGSwithL2(LabelEstimator):
    """Least squares with L2 on sparse rows (LBFGS.scala
    `SparseLBFGSwithL2`; JAX `:507-827`), by one of two routes:

    - **gram**: the rows reduced once to G = XᵀX, C = XᵀY and the column
      sums, a row block at a time densified on the device (at most
      `GRAM_BLOCK_SHARE` of its memory) and multiplied by cuBLAS, then
      `lbfgs_minimize` on the Gram objective, n gone. ``gram_precision``
      maps JAX's MXU passes to the card's modes for the block products:
      "highest" true float32, "high" TF32, "default" bfloat16 operands;
      the L-BFGS on G stays float32.
    - **iterative**: `sparse_matvec_fit`, three sparse products an
      iteration on the device CSR of X and of Xᵀ (cuSPARSE SpMM), JAX's
      closed-form step and history.

    Both fit the intercept by mean correction. `_route` prices the two
    in JAX's form (`:567-586`), one Gram pass plus 2·n·d² flops against
    ``num_iters`` · 3 sparse passes, with the card's rates: the weights
    `cost_model` resolves (measured on the card where its calibration
    file applies, else the H100's published peaks) where JAX's are TPU
    measurements. A sparse pass reads each slot's id and value and
    gathers and writes k floats; the card has the gather hardware the
    TPU lacks. With k = 2, 20 iterations and the H100's analytic weights
    (67 TFLOP/s fp32, 3.35 TB/s) the Gram route is the cheaper only where
    a row's w slots exceed d²/9,700 + d/240: dense rows below about
    9,700 features. Amazon's 100,000 features (a 40 GB Gram) and the
    reference suite's d = 16,384 at density 0.004 go iterative.

    JAX's host-scipy Gram for an outlier-dense row (`:773-791`) exists
    because its device routes pad rows to the widest; the port's routes
    work from the CSR, which has no padding, so a `SparseDataset` is
    priced by its mean row width. ``fit`` takes a `PaddedSparseDataset`
    (returns a `LinearMapper`), a `SparseDataset` (a
    `SparseLinearMapper`) or a dense `Dataset` (the Gram route, a
    `LinearMapper`). After a fit ``loss_history`` holds the objective
    at the start of each step (gram) or after it (iterative), as JAX's
    routes record them, and ``route`` the route taken."""

    def __init__(self, lam: float = 0.0, num_iters: int = 20,
                 memory_size: int = 10, fit_intercept: bool = True,
                 block_rows: int = 65536, method: Optional[str] = None,
                 gram_precision: str = "highest"):
        if method not in (None, "gram", "iterative"):
            raise ValueError(f"method must be gram|iterative, got {method!r}")
        if gram_precision not in ("default", "high", "highest"):
            raise ValueError("gram_precision must be default|high|highest, "
                             f"got {gram_precision!r}")
        self.lam = lam
        self.num_iters = num_iters
        self.memory_size = memory_size
        self.fit_intercept = fit_intercept
        self.block_rows = block_rows
        self.method = method
        self.gram_precision = gram_precision
        self.loss_history: Optional[torch.Tensor] = None
        self.route: Optional[str] = None

    def route_seconds(self, n: int, d: int, k: int, w: int):
        """(gram, iterative) seconds `_route` estimates for n rows of w
        slots, d features and k labels."""
        cw, mw, _ = cost_model.resolve_weights()
        slots = n * w
        gram = mw * 4.0 * n * d + cw * 2.0 * n * d * d
        iterative = self.num_iters * 3.0 * (
            mw * slots * (8.0 + 4.0 * k) + cw * 2.0 * slots * k)
        return gram, iterative

    def _route(self, n: int, d: int, k: int, w: int) -> str:
        if self.method is not None:
            return self.method
        gram, iterative = self.route_seconds(n, d, k, w)
        return "iterative" if iterative < gram else "gram"

    def _gram(self, blocks, d, Y, n, dev):
        G, C, colsum = gram_statistics(blocks, d, Y.shape[1],
                                       self.gram_precision, dev)
        if self.fit_intercept:
            xm, ym = colsum / n, Y.sum(dim=0) / n
            G -= n * torch.outer(xm, xm)
            C -= n * torch.outer(xm, ym)
        W, history = lbfgs_gram_fit(G, C, self.lam, self.num_iters,
                                    self.memory_size)
        self.loss_history = torch.tensor(history, dtype=torch.float32)
        return W, (ym - xm @ W if self.fit_intercept else None)

    def _iterative(self, X, Xt, d, Y, n):
        W, b, history = sparse_matvec_fit(
            X, Xt, Y, self.lam, n, d, self.num_iters, self.memory_size,
            self.fit_intercept)
        self.loss_history = history.cpu()
        return W, (b if self.fit_intercept else None)

    def fit(self, data, labels):
        if isinstance(data, PaddedSparseDataset):
            dev, n, d = data.val.device, data.count, data.dim
            Y = _labels(labels, n, dev)
            self.route = self._route(n, d, Y.shape[1], data.width)
            if self.route == "gram":
                rows = gram_row_block(d, self.block_rows, dev)
                W, b = self._gram(padded_row_blocks(data, Y, rows), d, Y, n,
                                  dev)
            else:
                data = data.with_column_form()
                W, b = self._iterative(data.csr(), data.csr_t(), d, Y, n)
            return LinearMapper(W, b)
        if isinstance(data, SparseDataset):
            X = data.csr()
            dev, n, d = X.device, data.count, data.dim
            Y = _labels(labels, n, dev)
            self.route = self._route(n, d, Y.shape[1],
                                     max(1, math.ceil(data.nnz / max(n, 1))))
            if self.route == "gram":
                rows = gram_row_block(d, self.block_rows, dev)
                W, b = self._gram(csr_row_blocks(data, Y, rows), d, Y, n,
                                  dev)
            else:
                W, b = self._iterative(X, data.csr_t(), d, Y, n)
            return SparseLinearMapper(W, b)
        X = data.array.to(torch.float32)
        dev, (n, d) = X.device, X.shape
        Y = _labels(labels, n, dev)
        rows = gram_row_block(d, self.block_rows, dev)
        self.route = "gram"
        W, b = self._gram(((X[s:s + rows], Y[s:s + rows])
                           for s in range(0, n, rows)), d, Y, n, dev)
        return LinearMapper(W, b)
