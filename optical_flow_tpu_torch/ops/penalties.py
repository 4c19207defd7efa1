"""Robust penalty functions (port of ``optical_flow_tpu/ops/penalties.py``).

Each penalty exposes ``value`` (d_type 0), ``deriv`` (1) and ``deriv_over_x``
(2, the IRLS weight).  Only the two penalties of the classic+nl family are
ported so far; the other names raise ``NotImplementedError`` until ROADMAP
queue 1 item 10 (other method families) ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def quadratic(x, p, d_type):
    """rho(x) = x^2 / sigma^2."""
    sig2 = p[0] ** 2
    if d_type == 0:
        return x**2 / sig2
    if d_type == 1:
        return 2.0 * x / sig2
    return torch.full_like(x, 2.0 / sig2)


def generalized_charbonnier(x, p, d_type):
    """rho(x) = (sig^2 + x^2)^a."""
    sig, a = p[0], p[1]
    base = sig**2 + x**2
    if d_type == 0:
        return base**a
    if d_type == 1:
        return 2.0 * a * x * base ** (a - 1.0)
    return 2.0 * a * base ** (a - 1.0)


PENALTIES = {
    "quadratic": quadratic,
    "generalized_charbonnier": generalized_charbonnier,
}

# Penalties of the JAX package that later PRs port (ROADMAP queue 1, item 10).
NOT_YET_PORTED = (
    "lorentzian",
    "charbonnier",
    "geman_mcclure",
    "huber",
    "tukey",
    "gaussian",
    "tdist",
    "tdist_unnorm",
)


@dataclasses.dataclass(frozen=True)
class Robust:
    """Frozen descriptor of a robust penalty: (name, params)."""

    name: str
    params: Tuple[float, ...] = (1.0,)

    def __post_init__(self):
        if self.name in NOT_YET_PORTED:
            raise NotImplementedError(
                f"penalty {self.name!r} is not ported yet (ROADMAP queue 1, item 10)"
            )
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
