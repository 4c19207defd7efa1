"""Plain k x k median filter of each flow field.

Bound by bytes: each field read once and written once, float32.  The
selection's compares are not counted (no operation count bounds it
tighter than the bytes do on this card at a 5 x 5 window).
"""

WORD = 4


def work(call):
    """``call``: {"planes", "H", "W"} -> (operations, bytes)."""
    px = call["planes"] * call["H"] * call["W"]
    return 0.0, float(2 * px * WORD)
