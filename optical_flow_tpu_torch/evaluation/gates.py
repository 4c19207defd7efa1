"""Accuracy gates on the Middlebury GT sequences (copy of the constants of ``benchmarks/middlebury.py``).

``REF_ORACLE`` is ``benchmarks/results_ref_oracle.json``: the NumPy
reference's classic+nl-fast (AAE deg, AEPE px) on each sequence's frame-10
pair.  A flow passes a method's gate if both errors lie within ``GATES``
(or the ``SEQ_GATES`` override) of the oracle's.  Copied so that a host
without JAX checks the port against them; a test pins the copy.
"""
from __future__ import annotations

REF_ORACLE = {
    "Dimetrodon": (2.3816, 0.12366),
    "Grove2": (1.3956, 0.09624),
    "Grove3": (4.8473, 0.46087),
    "Hydrangea": (1.9399, 0.15905),
    "RubberWhale": (2.463, 0.08025),
    "Urban2": (1.8909, 0.19729),
    "Urban3": (2.9732, 0.43296),
    "Venus": (3.3031, 0.2404),
}

GATES = {
    "classic+nl-fast": (0.2, 0.01),
    "classic+nl": (0.2, 0.02),
    "classic++": (0.2, 0.02),
    "ba": (0.2, 0.02),
    "hs": (0.2, 0.01),
}
SEQ_GATES = {
    ("hs", "Urban2"): (0.2, 0.05),
}
