"""Accuracy gates on the Middlebury GT sequences (copy of the constants of ``benchmarks/middlebury.py``).

``REF_ORACLE`` is ``benchmarks/results_ref_oracle.json``: the NumPy
reference's classic+nl-fast (AAE deg, AEPE px) on each sequence's frame-10
pair; ``METHOD_ORACLE`` is ``benchmarks/results_ref_oracle_methods.json``,
the same for ``hs``, ``classic++``, ``classic+nl`` and ``ba``.  A flow
passes a method's gate if both errors lie within ``GATES`` (or the
``SEQ_GATES`` override) of the oracle's.  Copied so that a host without
JAX checks the port against them; a test pins the copy.
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

METHOD_ORACLE = {
    "hs": {
        "Dimetrodon": (4.6013, 0.21858),
        "Grove2": (2.5873, 0.18419),
        "Grove3": (6.5664, 0.6784),
        "Hydrangea": (2.0076, 0.17088),
        "RubberWhale": (3.361, 0.10439),
        "Urban2": (3.8657, 0.4376),
        "Urban3": (7.3978, 0.83265),
        "Venus": (5.161, 0.31494),
    },
    "classic++": {
        "Dimetrodon": (2.5412, 0.12809),
        "Grove2": (2.0631, 0.141),
        "Grove3": (6.0546, 0.61608),
        "Hydrangea": (1.785, 0.15106),
        "RubberWhale": (2.6737, 0.08241),
        "Urban2": (2.5154, 0.35948),
        "Urban3": (4.6094, 0.56785),
        "Venus": (4.1668, 0.26594),
    },
    "classic+nl": {
        "Dimetrodon": (2.6668, 0.13746),
        "Grove2": (1.4444, 0.10079),
        "Grove3": (4.9609, 0.47053),
        "Hydrangea": (1.9649, 0.16103),
        "RubberWhale": (2.4235, 0.07653),
        "Urban2": (1.9419, 0.1981),
        "Urban3": (2.723, 0.38634),
        "Venus": (3.4207, 0.25084),
    },
    "ba": {
        "Dimetrodon": (4.1792, 0.19832),
        "Grove2": (2.2445, 0.15452),
        "Grove3": (6.2947, 0.64666),
        "Hydrangea": (1.8392, 0.1547),
        "RubberWhale": (2.8129, 0.08564),
        "Urban2": (2.7838, 0.36259),
        "Urban3": (4.7116, 0.5925),
        "Venus": (4.2076, 0.26713),
    },
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
