"""Colour- and occlusion-weighted median of both flow fields over (2 hsz + 1)^2 windows.

Operations a pixel, for K = (2 hsz + 1)^2 window entries and C guide
channels: each entry's weight takes a difference, a square and an add a
channel, then a scale, an exponential, the occlusion product and the floor
(3 C + 4); each field then needs at least one compare and one add an entry
to select its weighted median (2 + 2).  So K (3 C + 8), a lower bound:
a sort costs K log2 K compares a field.

Bytes: both fields, the occlusion map and the guide read once, both
filtered fields written once, float32.
"""

WORD = 4


def work(call):
    """``call``: {"B", "H", "W", "C", "hsz"} -> (operations, bytes)."""
    px = call["B"] * call["H"] * call["W"]
    K = (2 * call["hsz"] + 1) ** 2
    ops = px * K * (3 * call["C"] + 8)
    nbytes = px * ((3 + call["C"]) + 2) * WORD
    return float(ops), float(nbytes)
