"""Dense assembly of a :class:`FlowSystem` and its exact solve, for small grids
(port of ``optical_flow_tpu/solvers/direct.py``).

Host-side float64 numpy, the unknowns in the reference's Fortran
(column-major) pixel order, u block then v block: the exact solution that
the tests hold the iterative solvers to.
"""
from __future__ import annotations

import numpy as np

from optical_flow_tpu_torch.ops.stencil import FlowSystem


def _np(x):
    return x.detach().cpu().numpy().astype(np.float64)


def dense_matrix(sys: FlowSystem) -> np.ndarray:
    """A as a dense (2HW, 2HW) float64 array."""
    a11, a12, a22, wu_h, wu_v, wv_h, wv_v = (_np(f) for f in sys[:7])
    H, W = a11.shape
    N = H * W

    def fidx(i, j):
        return j * H + i

    A = np.zeros((2 * N, 2 * N))
    for i in range(H):
        for j in range(W):
            p = fidx(i, j)
            A[p, p] += a11[i, j]
            A[N + p, N + p] += a22[i, j]
            A[p, N + p] += a12[i, j]
            A[N + p, p] += a12[i, j]
            for di, dj, wu, wv in ((0, 1, wu_h, wv_h), (1, 0, wu_v, wv_v)):
                if i + di < H and j + dj < W:  # the edge to the right / below
                    q = fidx(i + di, j + dj)
                    for off, w in ((0, wu[i, j]), (N, wv[i, j])):
                        A[off + p, off + p] += w
                        A[off + q, off + q] += w
                        A[off + p, off + q] -= w
                        A[off + q, off + p] -= w
    return A


def dense_solve(sys: FlowSystem) -> np.ndarray:
    """The exact solution as a (H, W, 2) float64 array."""
    H, W = sys.a11.shape
    N = H * W
    b = np.concatenate([_np(sys.b_u).ravel(order="F"), _np(sys.b_v).ravel(order="F")])
    x = np.linalg.solve(dense_matrix(sys), b)
    return np.stack([x[:N].reshape((H, W), order="F"), x[N:].reshape((H, W), order="F")], axis=-1)
