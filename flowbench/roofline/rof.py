"""ROF structure-texture decomposition: Chambolle's primal-dual iterations on every image plane.

Operations a pixel of a plane: an iteration takes the divergence (3), the
primal (2), the forward gradient (2), the dual step (4), the dual's norm
with its floor at 1 (5) and the projection (2): 18; the final primal (5);
the normalisation to [-1, 1] and the texture's rescale to [0, 255] with the
structure subtracted (4 + 2 + 4), and the two minima and maxima (4): 14.

Bytes: the planes read once and the texture written once, float32.
"""

ITER_OPS = 18
ONCE_OPS = 5 + 14
WORD = 4


def work(call):
    """``call``: {"planes", "H", "W", "iters"} -> (operations, bytes)."""
    px = call["planes"] * call["H"] * call["W"]
    return float(px * (ITER_OPS * call["iters"] + ONCE_OPS)), float(2 * px * WORD)
