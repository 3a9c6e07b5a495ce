"""L-BFGS with a zoom line search on a tuple of tensors: a plain-PyTorch copy
of ``optax.lbfgs()`` (optax 0.2.6), the optimizer of the JAX package's BRS
predictors (``evaluation/predictors._lbfgs_minimize``).

It follows optax step for step:

* ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
  (optax/_src/transform.py:1497-1752): the memory of parameter and gradient
  differences in a ring of ``memory_size`` slots, the two-loop product with
  the identity scaled by ``<dg, dw> / |dg|^2`` (``min(1, 1 / |g|)`` at the
  first step), the direction negated;
* ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy="one")`` (optax/_src/linesearch.py:455-1646): the
  interval search from a step of 1 and the zoom with ``_cubicmin`` /
  ``_quadmin`` / bisection, the sufficient-decrease test with Hager and
  Zhang's approximate form (slope rtol 1e-4, approximate decrease rtol
  1e-6), the curvature test (rtol 0.9), and the safe step that keeps the
  lowest value seen with sufficient decrease;
* ``value_and_grad_from_state``: a step starts from the line search's last
  value and gradient when they are finite.

Every scalar is a tensor of the parameters' dtype (float32 in the
predictors) and every comparison and selection is optax's, so a run takes the same branches as JAX's jitted step unless a
float32 rounding difference (the sum order of a dot product) tips one.
``torch.optim.LBFGS`` is another algorithm (its first step and its line
search differ), so it is not used. The loop runs on the host: each line
search step reads its flags from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

Params = Tuple[torch.Tensor, ...]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5  # stepsize_precision


def vdot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.tree.vdot: the leaves' dot products summed in leaf order."""
    out = None
    for x, y in zip(a, b):
        d = torch.dot(x.reshape(-1), y.reshape(-1))
        out = d if out is None else out + d
    return out


def sq_norm(a: Sequence[torch.Tensor]) -> torch.Tensor:
    out = None
    for x in a:
        s = torch.sum(torch.square(x))
        out = s if out is None else out + s
    return out


def add_scale(a: Params, s: torch.Tensor, b: Params) -> Params:
    """optax.tree.add_scale: ``a + s * b`` leaf by leaf."""
    return tuple(x + s * y for x, y in zip(a, b))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none; the caller then skips it)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc**2 * v0 + (-(db**2)) * v1) / denom
    B = ((-(dc**3)) * v0 + db**3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


@dataclasses.dataclass
class _Search:
    """optax's ZoomLinesearchState (the fields the run reads)."""

    count: int
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: Params
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    interval_found: bool
    done: bool
    failed: bool
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: Params


@dataclasses.dataclass
class StepInfo:
    """One L-BFGS step: the value at the parameters it started from and at
    those it ended at, the step size its line search took, the line
    search's iterations and its last sufficient-decrease error (0 when the
    criterion holds)."""

    value: float
    value_after: float
    stepsize: float
    linesearch_steps: int
    decrease_error: float


class LBFGS:
    """``optax.lbfgs()`` over ``params`` (a tuple of float tensors) for the
    objective ``fn(params) -> scalar tensor``, differentiated by autograd
    with respect to the parameters only. :meth:`step` makes one update in
    place of :attr:`params`."""

    def __init__(self, fn: Callable[[Params], torch.Tensor], params: Sequence[torch.Tensor]):
        self.fn = fn
        self.params: Params = tuple(p.detach().clone() for p in params)
        dev, dtype = self.params[0].device, self.params[0].dtype
        self._scalar = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        zeros = tuple(torch.zeros_like(p) for p in self.params)
        self.count = 0
        self._prev_params, self._prev_grad = zeros, zeros
        self._dw: List[Params] = [zeros] * MEMORY_SIZE
        self._dg: List[Params] = [zeros] * MEMORY_SIZE
        self._rho = torch.zeros(MEMORY_SIZE, dtype=dtype, device=dev)
        # the line search's last value and gradient (value_and_grad_from_state)
        self._value = self._scalar(float("inf"))
        self._grad: Params = zeros

    def value_and_grad(self, params: Params) -> Tuple[torch.Tensor, Params]:
        ps = tuple(p.detach().requires_grad_(True) for p in params)
        with torch.enable_grad():
            value = self.fn(ps)
            grad = torch.autograd.grad(value, ps)
        return value.detach(), tuple(g.detach() for g in grad)

    # -- scale_by_lbfgs ----------------------------------------------------

    def _direction(self, grad: Params) -> Params:
        m, count = MEMORY_SIZE, self.count
        idx, prev = count % m, (count - 1) % m
        if count > 0:
            dw = tuple(p - q for p, q in zip(self.params, self._prev_params))
            dg = tuple(g - q for g, q in zip(grad, self._prev_grad))
            vd = vdot(dg, dw)
            rho = torch.where(vd == 0.0, self._scalar(0.0), 1.0 / vd)
        else:
            dw = dg = tuple(torch.zeros_like(p) for p in self.params)
            vd, rho = self._scalar(0.0), self._scalar(0.0)
        self._dw[prev], self._dg[prev] = dw, dg
        self._rho[prev] = rho
        if count > 0:
            den = sq_norm(dg)
            gamma = torch.where(den > 0.0, vd / den, self._scalar(1.0))
        else:
            gamma = torch.minimum(self._scalar(1.0), 1.0 / torch.sqrt(sq_norm(grad)))
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = self._rho[i] * vdot(self._dw[i], vec)
            vec = add_scale(vec, -alphas[i], self._dg[i])
        vec = tuple(gamma * v for v in vec)
        for i in order:
            beta = self._rho[i] * vdot(self._dg[i], vec)
            vec = add_scale(vec, alphas[i] - beta, self._dw[i])
        self._prev_params, self._prev_grad = self.params, grad
        self.count += 1
        return tuple(-1.0 * v for v in vec)

    # -- scale_by_zoom_linesearch ------------------------------------------

    def _on_line(self, stepsize, d: Params):
        value, grad = self.value_and_grad(add_scale(self.params, stepsize, d))
        return value, grad, vdot(grad, d)

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        dec = value - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
        dec = torch.minimum(torch.maximum(approx, delta), dec)
        dec = torch.clamp_min(dec, 0.0)
        return torch.where(torch.isnan(dec), self._scalar(float("inf")), dec)

    def _curvature_error(self, slope, slope_init):
        err = torch.clamp_min(torch.abs(slope) - CURV_RTOL * torch.abs(slope_init), 0.0)
        return torch.where(torch.isnan(err), self._scalar(float("inf")), err)

    def _search_interval(self, st: _Search, d: Params) -> _Search:
        """Algorithm 3.5 of Nocedal and Wright."""
        new = self._scalar(1.0) if st.count == 0 else INCREASE_FACTOR * st.stepsize
        value, grad, slope = self._on_line(new, d)
        dec = self._decrease_error(new, value, slope, st.value_init, st.slope_init)
        curv = self._curvature_error(slope, st.slope_init)
        error = torch.maximum(dec, curv)
        if bool(dec <= 0.0):
            st.safe_stepsize, st.safe_value, st.safe_grad = new, value, grad
        set_high = bool(dec > 0.0) or (bool(value >= st.value) and st.count > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            st.low, st.value_low, st.slope_low = new, value, slope
            st.high, st.value_high, st.slope_high = st.stepsize, st.value, st.slope
        else:
            st.low, st.value_low, st.slope_low = st.stepsize, st.value, st.slope
            st.high, st.value_high, st.slope_high = new, value, slope
        st.cubic_ref, st.value_cubic_ref = st.low, st.value_low
        st.interval_found = set_high or set_low or bool(error <= 0.0)
        st.done = bool(error <= 0.0)
        st.failed = st.count + 1 >= MAX_LINESEARCH_STEPS and not st.done
        st.stepsize, st.value, st.grad, st.slope = new, value, grad, slope
        st.decrease_error = dec
        st.count += 1
        return st

    def _zoom(self, st: _Search, d: Params) -> _Search:
        """Algorithm 3.6 of Nocedal and Wright."""
        low, high = st.low, st.high
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        too_small = bool(delta <= INTERVAL_THRESHOLD)
        cubic = _cubicmin(low, st.value_low, st.slope_low, high, st.value_high, st.cubic_ref,
                          st.value_cubic_ref)
        quad = _quadmin(low, st.value_low, st.slope_low, high, st.value_high)
        if bool((cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)):
            middle = cubic
        elif bool((quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)):
            middle = quad
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(middle, d)
        dec = self._decrease_error(middle, value, slope, st.value_init, st.slope_init)
        curv = self._curvature_error(slope, st.slope_init)
        error = torch.maximum(dec, curv)
        if bool(dec <= 0.0) and bool(value < st.safe_value):
            st.safe_stepsize, st.safe_value, st.safe_grad = middle, value, grad
        st.done = bool(error <= 0.0)
        old_low = (low, st.value_low, st.slope_low)
        old_high = (high, st.value_high, st.slope_high)
        set_high_mid = bool(dec > 0.0) or bool(value >= st.value_low)
        set_high_low = bool(slope * (high - low) >= 0.0) and not set_high_mid
        if set_high_mid:
            st.high, st.value_high, st.slope_high = middle, value, slope
        elif set_high_low:
            st.high, st.value_high, st.slope_high = old_low
        if not set_high_mid:
            st.low, st.value_low, st.slope_low = middle, value, slope
        # the new cubic reference: the old high where high moved, else the old low
        ref = old_high if set_high_mid or set_high_low else old_low
        st.cubic_ref, st.value_cubic_ref = ref[0], ref[1]
        failed = (st.count + 1 >= MAX_LINESEARCH_STEPS
                  or (too_small and bool(st.safe_stepsize > 0.0)))
        st.failed = failed and not st.done
        st.stepsize, st.value, st.grad, st.slope = middle, value, grad, slope
        st.decrease_error = dec
        st.count += 1
        return st

    def _linesearch(self, d: Params, value, grad) -> _Search:
        slope = vdot(d, grad)
        zero = self._scalar(0.0)
        st = _Search(count=0, stepsize=zero, value=value, grad=grad, slope=slope,
                     value_init=value, slope_init=slope,
                     decrease_error=self._scalar(float("inf")),
                     interval_found=False, done=False, failed=False,
                     low=zero, value_low=value, slope_low=slope,
                     high=zero, value_high=value, slope_high=slope,
                     cubic_ref=zero, value_cubic_ref=value,
                     safe_stepsize=zero, safe_value=value, safe_grad=grad)
        while not (st.done or st.failed):
            st = self._zoom(st, d) if st.interval_found else self._search_interval(st, d)
            if st.failed and (bool(st.safe_stepsize > 0.0) or bool(torch.isinf(st.decrease_error))):
                st.stepsize, st.value, st.grad = st.safe_stepsize, st.safe_value, st.safe_grad
        return st

    # -- one step ------------------------------------------------------------

    def step(self) -> StepInfo:
        """value_and_grad_from_state, the L-BFGS direction, the line search,
        and ``params + stepsize * direction``."""
        if bool(torch.isfinite(self._value)):
            value, grad = self._value, self._grad
        else:
            value, grad = self.value_and_grad(self.params)
        d = self._direction(grad)
        st = self._linesearch(d, value, grad)
        self.params = tuple(p + st.stepsize * u for p, u in zip(self.params, d))
        self._value, self._grad = st.value, st.grad
        return StepInfo(float(value), float(st.value), float(st.stepsize), st.count,
                        float(st.decrease_error))


def lbfgs_minimize(fn: Callable[[Params], torch.Tensor], params: Sequence[torch.Tensor],
                   max_steps: int, tol: float = 1e-6,
                   on_step: Optional[Callable[[StepInfo], None]] = None) -> Params:
    """Minimize ``fn`` over ``params`` with :class:`LBFGS`, at most
    ``max_steps`` steps, stopping after a step that started at a value of
    ``tol`` or less (the JAX package's ``_lbfgs_minimize``). ``on_step``
    sees each step's :class:`StepInfo`."""
    opt = LBFGS(fn, params)
    for _ in range(max_steps):
        info = opt.step()
        if on_step is not None:
            on_step(info)
        if info.value <= tol:
            break
    return opt.params
