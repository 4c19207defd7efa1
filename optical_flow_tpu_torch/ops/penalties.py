"""Robust penalty functions (port of ``optical_flow_tpu/ops/penalties.py``).

Each penalty exposes ``value`` (d_type 0), ``deriv`` (1) and ``deriv_over_x``
(2, the IRLS weight).  All ten penalties of the JAX package are here;
``mixture`` and ``spline_penalty`` are named but unimplemented, as there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


def _gammaln(x: float) -> float:
    return float(torch.lgamma(torch.tensor(x, dtype=torch.float64)))


def quadratic(x, p, d_type):
    """rho(x) = x^2 / sigma^2."""
    sig2 = p[0] ** 2
    if d_type == 0:
        return x**2 / sig2
    if d_type == 1:
        return 2.0 * x / sig2
    return torch.full_like(x, 2.0 / sig2)


def lorentzian(x, p, d_type):
    """rho(x) = log(1 + x^2 / (2 sigma^2))."""
    sig2 = p[0] ** 2
    if d_type == 0:
        return torch.log1p(x**2 / (2.0 * sig2))
    if d_type == 1:
        return 2.0 * x / (2.0 * sig2 + x**2)
    return 2.0 / (2.0 * sig2 + x**2)


def charbonnier(x, p, d_type):
    """MATLAB-exact Charbonnier with sigma^2 (not sigma) scaling:
    rho = 1 + (x / sig^2)^2, value sig2 sqrt(rho), weight 1 / (sig2 sqrt(rho))."""
    sig2 = p[0] ** 2
    sqrt_rho = torch.sqrt(1.0 + (x / sig2) ** 2)
    if d_type == 0:
        return sig2 * sqrt_rho
    if d_type == 1:
        return x / (sig2 * sqrt_rho)
    return 1.0 / (sig2 * sqrt_rho)


def generalized_charbonnier(x, p, d_type):
    """rho(x) = (sig^2 + x^2)^a."""
    sig, a = p[0], p[1]
    base = sig**2 + x**2
    if d_type == 0:
        return base**a
    if d_type == 1:
        return 2.0 * a * x * base ** (a - 1.0)
    return 2.0 * a * base ** (a - 1.0)


def geman_mcclure(x, p, d_type):
    """rho(x) = x^2 / (sigma^2 + x^2)."""
    sig2 = p[0] ** 2
    denom = sig2 + x**2
    if d_type == 0:
        return x**2 / denom
    if d_type == 1:
        return 2.0 * sig2 * x / denom**2
    return 2.0 * sig2 / denom**2


def huber(x, p, d_type):
    """Huber with threshold at |x| <= sigma^2 (MATLAB convention)."""
    sig2 = p[0] ** 2
    absx = torch.abs(x)
    mask = absx <= sig2
    if d_type == 0:
        return torch.where(mask, x**2, 2.0 * sig2 * absx - sig2**2)
    if d_type == 1:
        return torch.where(mask, 2.0 * x, 2.0 * sig2 * torch.sign(x))
    return torch.where(mask, 2.0, 2.0 * sig2 / torch.clamp(absx, min=1e-30))


def tukey(x, p, d_type):
    """Tukey biweight, saturating at 1/3."""
    sig = p[0]
    sig2 = sig**2
    mask = torch.abs(x) <= sig
    one_minus = 1.0 - x**2 / sig2
    if d_type == 0:
        return torch.where(mask, (1.0 - one_minus**3) / 3.0, 1.0 / 3.0)
    if d_type == 1:
        return torch.where(mask, 2.0 * x * one_minus**2 / sig2, 0.0)
    return torch.where(mask, 2.0 * one_minus**2 / sig2, 0.0)


def gaussian(x, p, d_type):
    """Gaussian negative log-likelihood."""
    sig = p[0]
    sig2 = sig**2
    if d_type == 0:
        return 0.5 * math.log(2.0 * math.pi) + math.log(sig) + 0.5 * (x / sig) ** 2
    if d_type == 1:
        return x / sig2
    return torch.full_like(x, 1.0 / sig2)


def tdist(x, p, d_type):
    """Normalized Student-t penalty, params (r, s)."""
    r, s = p[0], p[1]
    s2r = s**2 * r
    if d_type == 0:
        cnst = _gammaln(r / 2.0) - _gammaln((r + 1.0) / 2.0) + 0.5 * math.log(r * math.pi) + math.log(s)
        return (r + 1.0) / 2.0 * torch.log1p(x**2 / s2r) + cnst
    if d_type == 1:
        return (r + 1.0) * x / (s2r + x**2)
    return (r + 1.0) / (s2r + x**2)


def tdist_unnorm(x, p, d_type):
    """Student-t without the normalizer, params (r, s)."""
    r, s = p[0], p[1]
    s2r = s**2 * r
    if d_type == 0:
        return (r + 1.0) / 2.0 * torch.log1p(x**2 / s2r)
    if d_type == 1:
        return (r + 1.0) * x / (s2r + x**2)
    return (r + 1.0) / (s2r + x**2)


PENALTIES = {
    "quadratic": quadratic,
    "lorentzian": lorentzian,
    "charbonnier": charbonnier,
    "generalized_charbonnier": generalized_charbonnier,
    "geman_mcclure": geman_mcclure,
    "huber": huber,
    "tukey": tukey,
    "gaussian": gaussian,
    "tdist": tdist,
    "tdist_unnorm": tdist_unnorm,
}

# Named but unimplemented in the JAX package too.
UNIMPLEMENTED_PENALTIES = ("mixture", "spline_penalty")


@dataclasses.dataclass(frozen=True)
class Robust:
    """Frozen descriptor of a robust penalty: (name, params)."""

    name: str
    params: Tuple[float, ...] = (1.0,)

    def __post_init__(self):
        if self.name in UNIMPLEMENTED_PENALTIES:
            raise NotImplementedError(f"Penalty '{self.name}' is not implemented (as in the JAX package).")
        if self.name not in PENALTIES:
            raise ValueError(f"Unknown penalty {self.name!r}. Available: {sorted(PENALTIES)}")
        object.__setattr__(self, "params", tuple(float(v) for v in self.params))

    @property
    def param(self):
        return self.params

    def evaluate(self, x):
        return PENALTIES[self.name](x, self.params, 0)

    def deriv(self, x):
        return PENALTIES[self.name](x, self.params, 1)

    def deriv_over_x(self, x):
        """IRLS weight rho'(x)/x."""
        return PENALTIES[self.name](x, self.params, 2)
