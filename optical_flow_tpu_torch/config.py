"""Method presets (port of ``optical_flow_tpu/config.py``).

The classic+nl family is ported: ``classic+nl``, ``classic+nl-fast`` and
``classic+nl-full``, with the JAX table's constants.  Every other preset name
of the JAX package (and the ``classic-l`` alias) raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import numpy as np

from optical_flow_tpu_torch.ops.penalties import Robust

MEDIAN_FILTER_SIZE = [5, 5]


def _classic_nl():
    from optical_flow_tpu_torch.methods.classic_nl import ClassicNLOpticalFlow

    return ClassicNLOpticalFlow()


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
}

_NOT_YET_PORTED = {
    "hs-brightness": "ROADMAP queue 1, item 10 (other method families: hs)",
    "hs": "ROADMAP queue 1, item 10 (other method families: hs)",
    "ba-brightness": "ROADMAP queue 1, item 10 (other method families: BA)",
    "ba": "ROADMAP queue 1, item 10 (other method families: BA)",
    "classic-l": "ROADMAP queue 1, item 10 (other method families: BA, alias of 'ba')",
    "classic-c-brightness": "ROADMAP queue 1, item 10 (other method families: BA)",
    "classic-c": "ROADMAP queue 1, item 10 (other method families: BA)",
    "classic++": "ROADMAP queue 1, item 10 (other method families: BA + 'cubic' warp)",
    "classic-c-a": "ROADMAP queue 1, item 10 (other method families: alt-BA)",
}

# Attributes of the JAX method object that drive JAX-only machinery (device
# meshes, jit fusion, per-level checkpoint callbacks).  ``method_from_state``
# accepts them only at their inert defaults.
JAX_ONLY_DEFAULTS = {
    "spatial_mesh": None,
    "spatial_halo": "auto",
    "checkpoint": None,
    "fuse": None,
    "images": None,
}


def load_of_method(method: str):
    """Load a pre-configured optical flow method by name."""
    if method in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: {_NOT_YET_PORTED[method]}"
        )
    if method not in _PRESETS:
        raise ValueError(f"Unknown optical flow method: '{method}'")
    ctor = _PRESETS[method][0]
    ope = ctor()
    chain = []
    cur = method
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
    (``"float32"``).  Unknown attributes raise ``KeyError``; JAX-only ones
    raise ``ValueError`` unless they hold their inert default.
    """
    import torch

    from optical_flow_tpu_torch.methods.classic_nl import ClassicNLOpticalFlow

    ope = ClassicNLOpticalFlow()
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
        elif key == "rho_data":
            val = Robust(*val)
        setattr(ope, key, val)
    return ope
