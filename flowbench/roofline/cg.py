"""Block-Jacobi PCG on the coupled two-field 5-point flow system, from x0 = 0.

Operations a pixel, counting each add, multiply and divide once, from the
classic recurrence:

* an iteration: A p (two fields, each ``a11 p_u + a12 p_v`` and a weighted
  4-neighbour Laplacian of 7 operations: 11 a field, 22), p.Ap (4), the x
  and r updates (4 + 4), the 2x2 block preconditioner (6), r.z (4), the p
  update (4) and the stopping test's r.r (4): 52;
* once a solve: the diagonals (8), the determinant (3), the inverse block
  (5), the first preconditioned residual and its dot (10) and ||b||^2 (4): 30.

Bytes: the nine coefficient planes read once and the two solution planes
written once, float32.
"""

ITER_OPS = 52
SOLVE_OPS = 30
PLANES_IN = 9
PLANES_OUT = 2
WORD = 4


def work(call):
    """``call``: {"H", "W", "iters": [iterations of each item]} -> (operations, bytes)."""
    px = call["H"] * call["W"]
    ops = sum(px * (ITER_OPS * k + SOLVE_OPS) for k in call["iters"])
    return float(ops), float(len(call["iters"]) * px * (PLANES_IN + PLANES_OUT) * WORD)
