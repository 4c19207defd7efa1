// Whole block-Jacobi PCG solve of the coupled 2-field 5-point flow system,
// in one launch.  Replaces the Pallas kernel _cg_kernel / cg_solve_pallas
// (optical_flow_tpu/ops/pallas/cg_kernel.py), whose idea is residency: every
// plane stays in fast memory for the whole solve.
//
// Bound on the H100: latency and synchronisation, not arithmetic.  An
// iteration does ~60 flops per pixel (~0.2 us at 388x584 at the float32
// peak), but it needs two grid-wide sums, and each costs a grid barrier and
// a round trip to L2 (~2.4 us together, measured on 132 one-row bands).
// Two kernels:
//
// * cg_resident (the main path's sizes): one block per SM owns a band of
//   rows.  p, the coefficients and the preconditioner of the band stay in
//   shared memory and x, r and A p / z in registers (PPT pixels a thread)
//   for the whole solve, so inside the loop the only global traffic is one
//   double partial per block per sum and the band's first and last rows of
//   z.  Two barriers an iteration: (A) A p and p.Ap, barrier; (B) alpha, x,
//   r, z, r.z and r.r, publish z's boundary rows, barrier; (C) beta and
//   p = z + beta p on the band, and on the two halo rows from the
//   neighbours' z and the halo p this block already holds (the owner's
//   float expression on the owner's bits, so equal to the owner's p bit for
//   bit).  A system that one block holds runs as one block with
//   __syncthreads only.
// * cg_kernel (too large to stay on chip): a grid-stride loop over planes in
//   global memory (L2), three grid barriers an iteration.
//
// Every block reduces the per-block partials itself, in one fixed order (no
// float atomics), so every block takes the same branch and the result
// repeats run to run.
//
// Batch axis: B independent systems, each with its own stopping test and
// trip count, as the Pallas kernel's batch grid axis.  A resident launch
// holds `items` systems of `bands` blocks each (block b solves item
// b / bands); an item's sums run over its own blocks only, in one fixed
// order, so its bits depend only on its own band layout.  The loop runs
// while any item of the launch still iterates, a stopped item's state
// frozen, so that every block reaches every grid barrier.  One block an item
// (bands == 1) needs no barrier and loops on its own test.  Where the bands
// of all items do not fit on the card at once, the entry launches items one
// at a time; the streaming kernel always does.  Semantics follow the plain twin (pcg_solve_split):
// x0 = 0, the test ||r||^2 > rtol^2 ||b||^2 before every iteration, at most
// maxiter iterations, a zero step where p.Ap == 0 or r.z == 0, and the
// per-pixel 2x2 block-Jacobi preconditioner with 1e-12 guards.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;  // the caller sizes `partials` as 4 * kMaxBlocks

struct CgArgs {
  const float *a11, *a12, *a22, *wuh, *wuv, *wvh, *wvv, *bu, *bv;
  float* x;  // (H, W, 2)
  float *ru, *rv, *zu, *zv, *pu, *pv, *apu, *apv, *i00, *i01, *i11;
  double* partials;
  int* iters;  // [0]: running total, [1 + item]: this item's iteration count
  int item;    // the item this launch solves
  int H, W;
  float rtol2;
  int maxiter;
};

// Sum of a and b over the block, returned to every thread.
__device__ void block_sum2(double& a, double& b) {
  __shared__ double sh[2][kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
  }
  __syncthreads();
  a = 0.0;
  b = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) {
    a += sh[0][w];
    b += sh[1][w];
  }
  __syncthreads();
}

// Reduce this block's partial (a, b) and store it in slots sa, sb.
__device__ void publish2(double a, double b, double* partials, int sa, int sb) {
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    partials[sa * kMaxBlocks + blockIdx.x] = a;
    partials[sb * kMaxBlocks + blockIdx.x] = b;
  }
}

// Every block sums slots sa, sb over all blocks in the same fixed order.
__device__ void gather2(const double* partials, int sa, int sb, double& a, double& b) {
  a = 0.0;
  b = 0.0;
  for (int i = threadIdx.x; i < gridDim.x; i += kThreads) {
    a += partials[sa * kMaxBlocks + i];
    b += partials[sb * kMaxBlocks + i];
  }
  block_sum2(a, b);
}

// (F^T diag(w) F x)(i, j) for the 4-neighbour edge-weighted Laplacian, in the
// twin's operation order: ((eh + ev) - eh_left) - ev_up.
__device__ __forceinline__ float lap_apply(const float* wh, const float* wv, const float* x,
                                           int k, int i, int j, int H, int W) {
  const float xc = x[k];
  const float eh = wh[k] * (xc - (j < W - 1 ? x[k + 1] : 0.0f));
  const float ev = wv[k] * (xc - (i < H - 1 ? x[k + W] : 0.0f));
  const float ehl = j > 0 ? wh[k - 1] * (x[k - 1] - xc) : 0.0f;
  const float evu = i > 0 ? wv[k - W] * (x[k - W] - xc) : 0.0f;
  return ((eh + ev) - ehl) - evu;
}

__device__ __forceinline__ float lap_diag(const float* wh, const float* wv, int k, int i, int j,
                                          int W) {
  return ((wh[k] + (j > 0 ? wh[k - 1] : 0.0f)) + wv[k]) + (i > 0 ? wv[k - W] : 0.0f);
}

__global__ void __launch_bounds__(kThreads) cg_kernel(CgArgs s) {
  cg::grid_group grid = cg::this_grid();
  const int n = s.H * s.W;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  // setup: preconditioner, x = 0, r = b, z = M^-1 r, p = z
  double rz_part = 0.0, bb_part = 0.0;
  for (int k = first; k < n; k += stride) {
    const int i = k / s.W, j = k - (k / s.W) * s.W;
    const float du = s.a11[k] + lap_diag(s.wuh, s.wuv, k, i, j, s.W);
    const float dv = s.a22[k] + lap_diag(s.wvh, s.wvv, k, i, j, s.W);
    const float a12 = s.a12[k];
    const float dinv_u = fabsf(du) > 1e-12f ? 1.0f / du : 0.0f;
    const float dinv_v = fabsf(dv) > 1e-12f ? 1.0f / dv : 0.0f;
    const float det = du * dv - a12 * a12;
    const bool ok = fabsf(det) > 1e-12f;
    const float i00 = ok ? dv / det : dinv_u;
    const float i01 = ok ? -a12 / det : 0.0f;
    const float i11 = ok ? du / det : dinv_v;
    s.i00[k] = i00;
    s.i01[k] = i01;
    s.i11[k] = i11;
    const float bu = s.bu[k], bv = s.bv[k];
    const float zu = i00 * bu + i01 * bv;
    const float zv = i01 * bu + i11 * bv;
    s.x[2 * k] = 0.0f;
    s.x[2 * k + 1] = 0.0f;
    s.ru[k] = bu;
    s.rv[k] = bv;
    s.pu[k] = zu;
    s.pv[k] = zv;
    rz_part += (double)bu * zu + (double)bv * zv;
    bb_part += (double)bu * bu + (double)bv * bv;
  }
  publish2(rz_part, bb_part, s.partials, 0, 1);
  grid.sync();
  double rz_d, bb_d;
  gather2(s.partials, 0, 1, rz_d, bb_d);
  float rz = (float)rz_d;
  float rr = (float)bb_d;
  const float tol2 = s.rtol2 * rr;
  grid.sync();  // every block has read slots 0 and 1 before they are reused

  int it = 0;
  while (it < s.maxiter && rr > tol2) {
    // A p and p.Ap
    double pap_part = 0.0, unused = 0.0;  // slot 3 only ever holds zeros
    for (int k = first; k < n; k += stride) {
      const int i = k / s.W, j = k - (k / s.W) * s.W;
      const float pu = s.pu[k], pv = s.pv[k];
      const float apu = (s.a11[k] * pu + s.a12[k] * pv) + lap_apply(s.wuh, s.wuv, s.pu, k, i, j, s.H, s.W);
      const float apv = (s.a12[k] * pu + s.a22[k] * pv) + lap_apply(s.wvh, s.wvv, s.pv, k, i, j, s.H, s.W);
      s.apu[k] = apu;
      s.apv[k] = apv;
      pap_part += (double)pu * apu + (double)pv * apv;
    }
    publish2(pap_part, unused, s.partials, 0, 3);
    grid.sync();
    double pap_d;
    gather2(s.partials, 0, 3, pap_d, unused);
    const float pap = (float)pap_d;
    const float alpha = pap != 0.0f ? rz / pap : 0.0f;

    // x += alpha p;  r -= alpha A p;  z = M^-1 r;  r.z and r.r
    double rz_p = 0.0, rr_p = 0.0;
    for (int k = first; k < n; k += stride) {
      const float pu = s.pu[k], pv = s.pv[k];
      s.x[2 * k] += alpha * pu;
      s.x[2 * k + 1] += alpha * pv;
      const float ru = s.ru[k] - alpha * s.apu[k];
      const float rv = s.rv[k] - alpha * s.apv[k];
      const float zu = s.i00[k] * ru + s.i01[k] * rv;
      const float zv = s.i01[k] * ru + s.i11[k] * rv;
      s.ru[k] = ru;
      s.rv[k] = rv;
      s.zu[k] = zu;
      s.zv[k] = zv;
      rz_p += (double)ru * zu + (double)rv * zv;
      rr_p += (double)ru * ru + (double)rv * rv;
    }
    publish2(rz_p, rr_p, s.partials, 1, 2);
    grid.sync();
    double rz_new_d, rr_d;
    gather2(s.partials, 1, 2, rz_new_d, rr_d);
    const float rz_new = (float)rz_new_d;
    rr = (float)rr_d;
    const float beta = rz != 0.0f ? rz_new / rz : 0.0f;

    // p = z + beta p
    for (int k = first; k < n; k += stride) {
      s.pu[k] = s.zu[k] + beta * s.pu[k];
      s.pv[k] = s.zv[k] + beta * s.pv[k];
    }
    rz = rz_new;
    ++it;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    s.iters[1 + s.item] = it;
    s.iters[0] += it;
  }
}

// ---------------------------------------------------------------- resident

constexpr int kResThreads = 256;
constexpr int kResMaxBlocks = kResThreads;  // one reader thread per block

// How the blocks wait for each other: kBarBlock, one block alone;
// kBarCoop, cooperative groups' grid barrier (cooperative launch).  It was
// faster here than an arrive counter or per-block epoch flags (PERF.md).
enum BarrierKind { kBarBlock = 0, kBarCoop = 1 };

template <int kBar>
__device__ __forceinline__ void barrier_sync() {
  if constexpr (kBar == kBarCoop)
    cg::this_grid().sync();
  else
    __syncthreads();
}

struct ResArgs {
  const float *a11, *a12, *a22, *wuh, *wuv, *wvh, *wvv, *bu, *bv;  // (items, H, W)
  float* x;        // (items, H, W, 2)
  float* zhalo;    // (blocks, 2 sides, 2 fields, W): z on each band's first and last row
  double* partials;  // (2 parities, 2 sums, kResMaxBlocks)
  int* iters;      // [0]: running total, [1 + item0 + item]: each item's iterations
  int item0;       // the first item of this launch
  int bands;       // blocks an item
  int H, W;
  float rtol2;
  int maxiter;
};

// The arguments of one item: every plane offset to that item's.
__device__ __forceinline__ ResArgs item_args(ResArgs s, int item) {
  const long n = (long)item * s.H * s.W;
  s.a11 += n; s.a12 += n; s.a22 += n;
  s.wuh += n; s.wuv += n; s.wvh += n; s.wvv += n;
  s.bu += n; s.bv += n;
  s.x += 2 * n;
  return s;
}

// rows [row0, row0 + rows) of band b of nb: the first H % nb bands take one
// row more (band_bounds in ops/cuda/cg_kernel.py)
__device__ __forceinline__ void band_of(int b, int nb, int H, int& row0, int& rows) {
  const int base = H / nb, extra = H % nb;
  rows = base + (b < extra ? 1 : 0);
  row0 = b * base + (b < extra ? b : extra);
}

// the diagonal of the Laplacian from the four incident weights (0 where there
// is no neighbour), in the twin's order: ((wh + wh_left) + wv) + wv_up
__device__ __forceinline__ float diag4(float wh, float whl, float wv, float wvu) {
  return ((wh + whl) + wv) + wvu;
}

__device__ __forceinline__ void block_jacobi(float du, float dv, float a12, float& i00, float& i01,
                                             float& i11) {
  const float dinv_u = fabsf(du) > 1e-12f ? 1.0f / du : 0.0f;
  const float dinv_v = fabsf(dv) > 1e-12f ? 1.0f / dv : 0.0f;
  const float det = du * dv - a12 * a12;
  const bool ok = fabsf(det) > 1e-12f;
  i00 = ok ? dv / det : dinv_u;
  i01 = ok ? -a12 / det : 0.0f;
  i11 = ok ? du / det : dinv_v;
}

// z = M^-1 b at pixel (i, j), every input read from global memory: what a
// block computes for the halo rows of p = z at the start, bit for bit what
// the owner of those rows computes from the same values in shared memory.
__device__ void p0_at(const ResArgs& s, int i, int j, float& pu, float& pv) {
  const int g = i * s.W + j;
  const float du = s.a11[g] + diag4(s.wuh[g], j > 0 ? s.wuh[g - 1] : 0.0f, s.wuv[g],
                                    i > 0 ? s.wuv[g - s.W] : 0.0f);
  const float dv = s.a22[g] + diag4(s.wvh[g], j > 0 ? s.wvh[g - 1] : 0.0f, s.wvv[g],
                                    i > 0 ? s.wvv[g - s.W] : 0.0f);
  float i00, i01, i11;
  block_jacobi(du, dv, s.a12[g], i00, i01, i11);
  const float bu = s.bu[g], bv = s.bv[g];
  pu = i00 * bu + i01 * bv;
  pv = i01 * bu + i11 * bv;
}

// Sums v over the block; every thread gets the sums.
template <int N>
__device__ void block_sum(double (&v)[N], double (*red)[kResThreads / 32]) {
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] += __shfl_down_sync(0xffffffffu, v[q], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < N; ++q) red[q][warp] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) {
    v[q] = 0.0;
    for (int w = 0; w < kResThreads / 32; ++w) v[q] += red[q][w];
  }
  __syncthreads();
}

// A grid-wide sum in two steps, so that the caller can fetch other blocks'
// data between them.  grid_publish: the block's sums go to `partials` (the
// half of the epoch's parity, rewritten two epochs later when every block
// has read it), then the grid barrier.  grid_collect: thread i < gridDim.x
// fetches block i's sums (one round trip to L2 for all), and warp w adds
// those of items w, w + 8, ..., each in one fixed order (lane l takes the
// item's blocks l, l + 32, ..., then a shuffle tree), so every block gets
// the same bits for every item.  isum[q][item] holds them until the next
// collect; v gets this block's item's.  A single block (kBarBlock) skips both.
template <int N, int kBar>
__device__ void grid_publish(double (&v)[N], unsigned epoch, const ResArgs& s,
                             double (*red)[kResThreads / 32]) {
  block_sum<N>(v, red);
  if constexpr (kBar == kBarBlock) return;
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < N; ++q) s.partials[(2 * (epoch & 1) + q) * kResMaxBlocks + blockIdx.x] = v[q];
  barrier_sync<kBar>();
}

template <int N, int kBar>
__device__ void grid_collect(double (&v)[N], unsigned epoch, const ResArgs& s, int item,
                             double (*gath)[kResThreads], double (*isum)[kResMaxBlocks]) {
  if constexpr (kBar == kBarBlock) return;
  const int tid = threadIdx.x, lane = tid & 31, nbi = s.bands;
  if (tid < (int)gridDim.x)
#pragma unroll
    for (int q = 0; q < N; ++q) gath[q][tid] = __ldcg(s.partials + (2 * (epoch & 1) + q) * kResMaxBlocks + tid);
  __syncthreads();
  for (int it = tid >> 5; it < (int)gridDim.x / nbi; it += kResThreads / 32) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      double a = 0.0;
      for (int i = lane; i < nbi; i += 32) a += gath[q][it * nbi + i];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
      if (lane == 0) isum[q][it] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = isum[q][item];
}

// One block per band of rows; block b works on item b / bands of the launch.
// Shared memory, in floats: p_u, p_v with a halo row above and below,
// (rows + 2) W each; the vertical weights with the row above, (rows + 1) W
// each; the horizontal weights, the data block and the preconditioner,
// rows W each.  Registers: x, r and t (A p, then z) of PPT pixels a thread.
template <int PPT, int kBar>
__global__ void __launch_bounds__(kResThreads, 1) cg_resident(ResArgs base) {
  extern __shared__ float smem[];
  __shared__ double red[2][kResThreads / 32];
  __shared__ double gath[2][kResThreads];
  __shared__ double isum[2][kResMaxBlocks];  // each item's sums, from grid_collect
  __shared__ float tol2s[kResMaxBlocks];     // each item's rtol^2 ||b||^2
  __shared__ unsigned char act[kResMaxBlocks];  // each item still iterates
  const int nb = base.bands, item = blockIdx.x / nb, b = blockIdx.x, tid = threadIdx.x;
  const int items = gridDim.x / nb;
  const ResArgs s = item_args(base, item);
  const int W = s.W, H = s.H;
  int row0, rows;
  band_of(b - item * nb, nb, H, row0, rows);
  const int n = rows * W;
  float* spu = smem;
  float* spv = spu + (rows + 2) * W;
  float* swuv = spv + (rows + 2) * W;
  float* swvv = swuv + (rows + 1) * W;
  float* swuh = swvv + (rows + 1) * W;
  float* swvh = swuh + n;
  float* sa11 = swvh + n;
  float* sa12 = sa11 + n;
  float* sa22 = sa12 + n;
  float* si00 = sa22 + n;
  float* si01 = si00 + n;
  float* si11 = si01 + n;
  const bool above = row0 > 0, below = row0 + rows < H;
  unsigned epoch = 0;

  for (int j = tid; j < W; j += kResThreads) {
    swuv[j] = above ? s.wuv[(row0 - 1) * W + j] : 0.0f;
    swvv[j] = above ? s.wvv[(row0 - 1) * W + j] : 0.0f;
    float pu = 0.0f, pv = 0.0f;
    if (above) p0_at(s, row0 - 1, j, pu, pv);
    spu[j] = pu;
    spv[j] = pv;
    pu = 0.0f;
    pv = 0.0f;
    if (below) p0_at(s, row0 + rows, j, pu, pv);
    spu[(rows + 1) * W + j] = pu;
    spv[(rows + 1) * W + j] = pv;
  }
  for (int q = tid; q < n; q += kResThreads) {
    const int g = row0 * W + q;
    swuh[q] = s.wuh[g];
    swvh[q] = s.wvh[g];
    swuv[W + q] = s.wuv[g];
    swvv[W + q] = s.wvv[g];
    sa11[q] = s.a11[g];
    sa12[q] = s.a12[g];
    sa22[q] = s.a22[g];
  }
  __syncthreads();

  int ij[PPT];  // (band row << 16) | column, or -1 past the band
  float xu[PPT], xv[PPT], ru[PPT], rv[PPT], tu[PPT], tv[PPT];
  double sums[2] = {0.0, 0.0};
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int q = k * kResThreads + tid;
    ij[k] = -1;
    xu[k] = xv[k] = ru[k] = rv[k] = tu[k] = tv[k] = 0.0f;
    if (q < n) {
      const int il = q / W, j = q - il * W, i = row0 + il;
      ij[k] = (il << 16) | j;
      const float du = sa11[q] + diag4(swuh[q], j > 0 ? swuh[q - 1] : 0.0f, swuv[W + q],
                                       i > 0 ? swuv[q] : 0.0f);
      const float dv = sa22[q] + diag4(swvh[q], j > 0 ? swvh[q - 1] : 0.0f, swvv[W + q],
                                       i > 0 ? swvv[q] : 0.0f);
      float i00, i01, i11;
      block_jacobi(du, dv, sa12[q], i00, i01, i11);
      si00[q] = i00;
      si01[q] = i01;
      si11[q] = i11;
      const float bu = s.bu[row0 * W + q], bv = s.bv[row0 * W + q];
      const float zu = i00 * bu + i01 * bv;
      const float zv = i01 * bu + i11 * bv;
      ru[k] = bu;
      rv[k] = bv;
      spu[W + q] = zu;
      spv[W + q] = zv;
      sums[0] += (double)bu * zu + (double)bv * zv;
      sums[1] += (double)bu * bu + (double)bv * bv;
    }
  }
  grid_publish<2, kBar>(sums, ++epoch, s, red);  // also orders the p writes above
  grid_collect<2, kBar>(sums, epoch, s, item, gath, isum);
  float rz = (float)sums[0];
  float rr = (float)sums[1];
  const float tol2 = s.rtol2 * rr;

  // every item's stopping test, the same in every block (kBarCoop); one
  // block alone tests only its own item
  bool active = 0 < s.maxiter && rr > tol2, any = active;
  if constexpr (kBar != kBarBlock) {
    bool mine = false;
    if (tid < items) {
      const float bb = (float)isum[1][tid];
      tol2s[tid] = s.rtol2 * bb;
      act[tid] = mine = 0 < s.maxiter && bb > tol2s[tid];
    }
    any = __syncthreads_or(mine);
    active = act[item];
  }

  int it = 0;
  for (int step = 0; any; ++step) {
    // (A) t = A p, p.Ap
    double pap[1] = {0.0};
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (ij[k] < 0 || !active) continue;
      const int il = ij[k] >> 16, j = ij[k] & 0xffff, i = row0 + il;
      const int q = il * W + j, c = q + W;  // c: the pixel in the haloed planes
      const float pu = spu[c], pv = spv[c];
      const float pur = j < W - 1 ? spu[c + 1] : 0.0f, pvr = j < W - 1 ? spv[c + 1] : 0.0f;
      const float pud = i < H - 1 ? spu[c + W] : 0.0f, pvd = i < H - 1 ? spv[c + W] : 0.0f;
      // (F^T diag(w) F p) in the twin's order ((eh + ev) - eh_left) - ev_up
      const float eh_u = swuh[q] * (pu - pur), ev_u = swuv[c] * (pu - pud);
      const float eh_v = swvh[q] * (pv - pvr), ev_v = swvv[c] * (pv - pvd);
      const float ehl_u = j > 0 ? swuh[q - 1] * (spu[c - 1] - pu) : 0.0f;
      const float ehl_v = j > 0 ? swvh[q - 1] * (spv[c - 1] - pv) : 0.0f;
      const float evu_u = i > 0 ? swuv[q] * (spu[q] - pu) : 0.0f;
      const float evu_v = i > 0 ? swvv[q] * (spv[q] - pv) : 0.0f;
      const float a12 = sa12[q];
      tu[k] = (sa11[q] * pu + a12 * pv) + (((eh_u + ev_u) - ehl_u) - evu_u);
      tv[k] = (a12 * pu + sa22[q] * pv) + (((eh_v + ev_v) - ehl_v) - evu_v);
      pap[0] += (double)pu * tu[k] + (double)pv * tv[k];
    }
    grid_publish<1, kBar>(pap, ++epoch, s, red);
    grid_collect<1, kBar>(pap, epoch, s, item, gath, isum);
    const float pap_f = (float)pap[0];
    const float alpha = pap_f != 0.0f ? rz / pap_f : 0.0f;

    // (B) x += alpha p;  r -= alpha A p;  t = z = M^-1 r;  r.z, r.r;  z's boundary rows out
    double rzrr[2] = {0.0, 0.0};
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (ij[k] < 0 || !active) continue;
      const int il = ij[k] >> 16, j = ij[k] & 0xffff, q = il * W + j;
      xu[k] += alpha * spu[q + W];
      xv[k] += alpha * spv[q + W];
      ru[k] = ru[k] - alpha * tu[k];
      rv[k] = rv[k] - alpha * tv[k];
      const float i01 = si01[q];
      tu[k] = si00[q] * ru[k] + i01 * rv[k];
      tv[k] = i01 * ru[k] + si11[q] * rv[k];
      if (kBar != kBarBlock) {
        if (il == 0) {
          s.zhalo[(b * 4 + 0) * W + j] = tu[k];
          s.zhalo[(b * 4 + 1) * W + j] = tv[k];
        }
        if (il == rows - 1) {
          s.zhalo[(b * 4 + 2) * W + j] = tu[k];
          s.zhalo[(b * 4 + 3) * W + j] = tv[k];
        }
      }
      rzrr[0] += (double)ru[k] * tu[k] + (double)rv[k] * tv[k];
      rzrr[1] += (double)ru[k] * ru[k] + (double)rv[k] * rv[k];
    }
    grid_publish<2, kBar>(rzrr, ++epoch, s, red);
    grid_collect<2, kBar>(rzrr, epoch, s, item, gath, isum);

    if (active) {
      const float rz_new = (float)rzrr[0];
      rr = (float)rzrr[1];
      const float beta = rz != 0.0f ? rz_new / rz : 0.0f;

      // (C) p = z + beta p on the band and on both halo rows
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (ij[k] < 0) continue;
        const int c = ((ij[k] >> 16) + 1) * W + (ij[k] & 0xffff);
        spu[c] = tu[k] + beta * spu[c];
        spv[c] = tv[k] + beta * spv[c];
      }
      if (kBar != kBarBlock) {
        for (int j = tid; j < W; j += kResThreads) {
          if (above) {
            spu[j] = __ldcg(&s.zhalo[((b - 1) * 4 + 2) * W + j]) + beta * spu[j];
            spv[j] = __ldcg(&s.zhalo[((b - 1) * 4 + 3) * W + j]) + beta * spv[j];
          }
          if (below) {
            const int c = (rows + 1) * W + j;
            spu[c] = __ldcg(&s.zhalo[((b + 1) * 4 + 0) * W + j]) + beta * spu[c];
            spv[c] = __ldcg(&s.zhalo[((b + 1) * 4 + 1) * W + j]) + beta * spv[c];
          }
        }
      }
      rz = rz_new;
      ++it;
    }
    if constexpr (kBar == kBarBlock) {
      __syncthreads();
      active = any = it < s.maxiter && rr > tol2;
    } else {
      // an item that ran this iteration goes on while its test holds; the
      // test reads the item's r.r of this collect, as its own blocks do
      bool mine = false;
      if (tid < items && act[tid]) act[tid] = mine = step + 1 < s.maxiter && (float)isum[1][tid] > tol2s[tid];
      any = __syncthreads_or(mine);
      active = act[item];
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (ij[k] < 0) continue;
    const int g = (row0 + (ij[k] >> 16)) * W + (ij[k] & 0xffff);
    s.x[2 * g] = xu[k];
    s.x[2 * g + 1] = xv[k];
  }
  if (b == item * nb && tid == 0) {
    s.iters[1 + s.item0 + item] = it;
    atomicAdd(&s.iters[0], it);
  }
}

template <int PPT, int kBar>
cudaError_t launch_resident(ResArgs& s, int blocks, int smem, cudaStream_t st) {
  const void* fn = (const void*)cg_resident<PPT, kBar>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* kargs[] = {&s};
  if (kBar == kBarBlock) return cudaLaunchKernel(fn, dim3(blocks), dim3(kResThreads), kargs, smem, st);
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kResThreads), kargs, smem, st);
}

template <int kBar>
cudaError_t launch_resident_ppt(ResArgs& s, int blocks, int ppt, int smem, cudaStream_t st) {
  switch (ppt) {
    case 1: return launch_resident<1, kBar>(s, blocks, smem, st);
    case 2: return launch_resident<2, kBar>(s, blocks, smem, st);
    case 4: return launch_resident<4, kBar>(s, blocks, smem, st);
    case 8: return launch_resident<8, kBar>(s, blocks, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The card's SM count and the shared memory a block may opt in to.
extern "C" int device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// The resident solve of B (H, W) systems: `bands` blocks an item (1: one
// block, no grid barrier), `items` systems a launch (B, or 1 to launch once
// per item on the stream), PPT pixels a thread, `smem` bytes of dynamic
// shared memory, as cg_plan in ops/cuda/cg_kernel.py chooses them.  zhalo:
// items * bands * 4 * W floats; partials: 4 * kResMaxBlocks doubles;
// iters: 1 + B ints.
extern "C" int cg_resident_f32(const float* a11, const float* a12, const float* a22, const float* wuh,
                               const float* wuv, const float* wvh, const float* wvv, const float* bu,
                               const float* bv, float* x, float* zhalo, double* partials, int* iters,
                               int B, int H, int W, float rtol2, int maxiter, int bands, int items,
                               int ppt, int smem, void* stream) {
  if (B < 1 || items < 1 || items > B || bands < 1 || bands > H || W >= 65536 ||
      (bands > 1 && items * bands > kResMaxBlocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long n = (long)H * W;
  for (int i0 = 0; i0 < B; i0 += items) {
    const int m = B - i0 < items ? B - i0 : items;
    ResArgs s;
    s.a11 = a11 + i0 * n; s.a12 = a12 + i0 * n; s.a22 = a22 + i0 * n;
    s.wuh = wuh + i0 * n; s.wuv = wuv + i0 * n; s.wvh = wvh + i0 * n; s.wvv = wvv + i0 * n;
    s.bu = bu + i0 * n; s.bv = bv + i0 * n;
    s.x = x + 2 * i0 * n; s.zhalo = zhalo; s.partials = partials; s.iters = iters;
    s.item0 = i0; s.bands = bands;
    s.H = H; s.W = W; s.rtol2 = rtol2; s.maxiter = maxiter;
    const cudaError_t err = bands == 1 ? launch_resident_ppt<kBarBlock>(s, m, ppt, smem, st)
                                       : launch_resident_ppt<kBarCoop>(s, m * bands, ppt, smem, st);
    if (err != cudaSuccess) return (int)err;
    const cudaError_t last = cudaGetLastError();
    if (last != cudaSuccess) return (int)last;
  }
  return (int)cudaSuccess;
}

// B systems of coefficient planes (B, H, W) each; x: (B, H, W, 2) out; work:
// 11 planes (H, W), reused item after item; partials: 4 * kMaxBlocks
// doubles; iters: 1 + B ints.  One launch per item.
extern "C" int cg_solve_f32(const float* a11, const float* a12, const float* a22, const float* wuh,
                            const float* wuv, const float* wvh, const float* wvv, const float* bu,
                            const float* bv, float* x, float* work, double* partials, int* iters,
                            int B, int H, int W, float rtol2, int maxiter, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)H * W;
  CgArgs s;
  float* planes[11];
  for (int q = 0; q < 11; ++q) planes[q] = work + q * n;
  s.ru = planes[0]; s.rv = planes[1]; s.zu = planes[2]; s.zv = planes[3];
  s.pu = planes[4]; s.pv = planes[5]; s.apu = planes[6]; s.apv = planes[7];
  s.i00 = planes[8]; s.i01 = planes[9]; s.i11 = planes[10];
  s.partials = partials;
  s.iters = iters;
  s.H = H; s.W = W; s.rtol2 = rtol2; s.maxiter = maxiter;

  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_kernel, kThreads, 0);
  long blocks = (long)per_sm * sms;
  const long want = (n + kThreads - 1) / kThreads;
  if (blocks > want) blocks = want;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  for (int item = 0; item < B; ++item) {
    s.a11 = a11 + item * n; s.a12 = a12 + item * n; s.a22 = a22 + item * n;
    s.wuh = wuh + item * n; s.wuv = wuv + item * n; s.wvh = wvh + item * n; s.wvv = wvv + item * n;
    s.bu = bu + item * n; s.bv = bv + item * n;
    s.x = x + 2 * item * n;
    s.item = item;
    void* kargs[] = {&s};
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)cg_kernel, dim3((unsigned)blocks),
                                                  dim3(kThreads), kargs, 0,
                                                  static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
