"""Method presets (port of ``optical_flow_tpu/config.py``).

Every preset of the JAX package with the JAX table's constants: the
Classic+NL, BA, Horn–Schunck and alt-BA (``classic-c-a``) families, and the
``classic-l`` alias of ``ba``.
"""
from __future__ import annotations

import operator

import numpy as np

from optical_flow_tpu_torch.ops.penalties import Robust

MEDIAN_FILTER_SIZE = [5, 5]


def _penalties(name, spatial, data):
    """The three robust-penalty slots: two spatial (u, v) + one data term."""

    def r(p):
        return Robust(name, p if isinstance(p, tuple) else (p,))

    return {
        "rho_spatial_u": [r(spatial), r(spatial)],
        "rho_spatial_v": [r(spatial), r(spatial)],
        "rho_data": r(data),
    }


def _classic_nl():
    from optical_flow_tpu_torch.methods.classic_nl import ClassicNLOpticalFlow

    return ClassicNLOpticalFlow()


def _hs():
    from optical_flow_tpu_torch.methods.hs import HSOpticalFlow

    return HSOpticalFlow()


def _ba():
    from optical_flow_tpu_torch.methods.ba import BAOpticalFlow

    return BAOpticalFlow()


def _alt_ba():
    from optical_flow_tpu_torch.methods.alt_ba import AltBAOpticalFlow

    return AltBAOpticalFlow()


# name -> (constructor, base preset name or None, settings factory)
_PRESETS = {
    "classic+nl": (
        _classic_nl,
        None,
        lambda: {
            "texture": True,
            "median_filter_size": MEDIAN_FILTER_SIZE,
            "alp": 0.95,
            "area_hsz": 7,
            "sigma_i": 7,
            "color_images": np.ones((1, 1, 3)),
            "lambda_": 3,
            "lambda_q": 3,
        },
    ),
    "classic+nl-fast": (
        _classic_nl,
        "classic+nl",
        lambda: {"max_iters": 3, "gnc_iters": 2, "display": True},
    ),
    "classic+nl-full": (_classic_nl, "classic+nl", lambda: {"fullVersion": True}),
    "hs-brightness": (
        _hs,
        None,
        lambda: {"median_filter_size": MEDIAN_FILTER_SIZE, "lambda_": 10, "lambda_q": 10},
    ),
    "hs": (
        _hs,
        None,
        lambda: {
            "median_filter_size": MEDIAN_FILTER_SIZE,
            "texture": True,
            "lambda_": 40,
            "lambda_q": 40,
            "display": True,
        },
    ),
    "ba-brightness": (
        _ba,
        None,
        lambda: {
            "median_filter_size": MEDIAN_FILTER_SIZE,
            "lambda_": 0.045,
            "lambda_q": 0.045,
            **_penalties("lorentzian", 0.1, 3.5),
        },
    ),
    "ba": (
        _ba,
        "ba-brightness",
        lambda: {
            "texture": True,
            "lambda_": 0.06,
            "lambda_q": 0.06,
            **_penalties("lorentzian", 0.03, 1.5),
        },
    ),
    "classic-c-a": (
        _alt_ba,
        None,
        lambda: {
            "median_filter_size": MEDIAN_FILTER_SIZE,
            "texture": True,
            "display": False,
            "lambda2": 1e2,
            "lambda3": 1,
            "weightRatio": 1e2,  # lambda2 / lambda3
            "itersLO": 5,
            "lambda_": 5,
            "lambda_q": 5,
            **_penalties("charbonnier", 1e-3, 1e-3),
            # the default trajectory diverges on real frames, in the reference
            # too; the level-rollback guard keeps the flow finite and scoreable
            # ({"guard_flow": None} reproduces the divergence)
            "guard_flow": 1e9,
        },
    ),
    "classic-c-brightness": (
        _ba,
        None,
        lambda: {
            "median_filter_size": MEDIAN_FILTER_SIZE,
            "texture": False,
            "lambda_": 3,
            "lambda_q": 3,
            **_penalties("charbonnier", 1e-3, 1e-3),
        },
    ),
    "classic-c": (
        _ba,
        "classic-c-brightness",
        lambda: {"texture": True, "lambda_": 5, "lambda_q": 5},
    ),
    "classic++": (
        _ba,
        None,
        lambda: {
            "median_filter_size": MEDIAN_FILTER_SIZE,
            "texture": True,
            "interpolation_method": "bi-cubic",
            "lambda_": 3,
            "lambda_q": 3,
            **_penalties("generalized_charbonnier", (1e-3, 0.45), (1e-3, 0.45)),
        },
    ),
}

_ALIASES = {"classic-l": "ba"}

# the JAX package's method classes, by name, for ``method_from_state``
_CLASSES = {
    "ClassicNLOpticalFlow": _classic_nl,
    "BAOpticalFlow": _ba,
    "HSOpticalFlow": _hs,
    "AltBAOpticalFlow": _alt_ba,
}

# Attributes of the JAX method object that drive JAX-only machinery (a JAX
# device mesh, jit fusion, per-level checkpoint callbacks).  ``method_from_state``
# accepts them only at their inert defaults: a JAX ``Mesh`` cannot be carried
# across, so a caller passes the port's own mesh (``estimate_flow(mesh=)``).
JAX_ONLY_DEFAULTS = {
    "spatial_mesh": None,
    "checkpoint": None,
    "fuse": None,
    "images": None,
}


def available_methods():
    """All preset names of the JAX package, aliases included."""
    return sorted(_PRESETS) + sorted(_ALIASES)


def load_of_method(method: str):
    """Load a pre-configured optical flow method by name."""
    name = _ALIASES.get(method, method)
    if name not in _PRESETS:
        raise ValueError(f"Unknown optical flow method: '{method}'")
    ope = _PRESETS[name][0]()
    chain = []
    cur = name
    while cur is not None:
        chain.append(_PRESETS[cur][2])
        cur = _PRESETS[cur][1]
    for fn in reversed(chain):  # base settings first, leaf overrides last
        for key, val in fn().items():
            setattr(ope, key, val)
    return ope


def method_from_state(state: dict):
    """Build the port's method object from a JAX method object's settings.

    ``state`` maps attribute names to plain Python / numpy values, as read
    from ``vars(optical_flow_tpu.config.load_of_method(name))``, with each
    robust penalty given as ``(name, params)`` and ``dtype`` as a dtype name
    (``"float32"``).  ``state["__class__"]`` names the JAX object's class
    (``"ClassicNLOpticalFlow"``, ``"BAOpticalFlow"``, ``"HSOpticalFlow"`` or
    ``"AltBAOpticalFlow"``; Classic+NL when absent), and the port builds its counterpart.  Unknown
    attributes and classes raise ``KeyError``; JAX-only attributes raise
    ``ValueError`` unless they hold their inert default.  ``spatial_halo``
    carries across as ``"auto"`` or an integer.
    """
    import torch

    state = dict(state)
    cls = state.pop("__class__", "ClassicNLOpticalFlow")
    if cls not in _CLASSES:
        raise KeyError(f"no port of method class {cls!r}")
    ope = _CLASSES[cls]()
    for key, val in state.items():
        if key in JAX_ONLY_DEFAULTS:
            if val != JAX_ONLY_DEFAULTS[key]:
                raise ValueError(f"{key}={val!r} has no counterpart in the port")
            continue
        if not hasattr(ope, key):
            raise KeyError(f"unknown method attribute {key!r}")
        if key == "dtype":
            val = getattr(torch, str(val))
        elif key in ("rho_spatial_u", "rho_spatial_v"):
            val = [Robust(name, params) for name, params in val]
        elif key in ("rho_data", "rho_couple"):
            val = Robust(*val)
        elif key == "spatial_halo" and val != "auto":
            val = operator.index(val)
        setattr(ope, key, val)
    return ope
