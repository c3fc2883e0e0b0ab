"""Dense L-BFGS least squares with L2.

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ...workflow.pipeline import LabelEstimator
from .linear import LinearMapper

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
