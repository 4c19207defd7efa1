// Whole block-Jacobi PCG solve of the coupled 2-field 5-point flow system,
// in one launch.  Replaces the Pallas kernel _cg_kernel / cg_solve_pallas
// (optical_flow_tpu/ops/pallas/cg_kernel.py), whose idea is residency: every
// plane stays in fast memory for the whole solve.
//
// Bound on the H100: latency and synchronisation at the main path's sizes,
// device memory above them.  An iteration does ~60 flops per pixel (~0.2 us
// at 388x584 at the float32 peak), but it needs two grid-wide sums, and
// each costs a grid barrier and a round trip to L2 (~2.4 us together,
// measured on 132 one-row bands).  Two kernels:
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
// * cg_stream (too large to stay on chip): planes in device memory, two
//   sweeps and two grid barriers an iteration, 28 plane-passes (a plane
//   read or written once).  Sweep 1, with alpha and beta of the iteration
//   before: on row tiles of kSwCols columns and their one-pixel ring,
//   z = M^-1 r recomputed from r and the seven coefficient planes that A p
//   reads anyway, p = z + beta p_old (p double-buffered by the iteration's
//   parity: a neighbour reads p_old on its ring while this tile writes p),
//   the deferred x += alpha p_old, A p and the share of p.Ap; reads r,
//   p_old, x and the coefficients (13 planes), writes p, x and A p (6).
//   Sweep 2, with alpha: r -= alpha A p, z from the three preconditioner
//   planes written once at setup, the shares of r.z and r.r; reads 7,
//   writes r (2).  A last pass applies the final x += alpha p.  Every
//   per-pixel expression is the twin's, in its order, so the deferral and
//   the recomputed z change no pixel's bits; only the sums' partition
//   differs from the twin's.
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


// ---------------------------------------------------------------- streaming

constexpr int kSwCols = 256;              // a tile's columns, one thread each
constexpr int kSwThreads = kSwCols + 32;  // and a warp whose lanes 0 and 1 take the ring's columns
constexpr int kSwWarps = kSwThreads / 32;
constexpr int kSwMinBlocks = 2;           // blocks an SM: STREAM_BLOCKS_PER_SM in ops/cuda/cg_kernel.py

struct StreamArgs {
  const float *a11, *a12, *a22, *wuh, *wuv, *wvh, *wvv, *bu, *bv;  // (H, W)
  float* x;                                 // (H, W, 2)
  float *ru, *rv, *apu, *apv, *i00, *i01, *i11;
  float* p[2][2];                           // p by parity of the iteration, then field
  double* partials;                         // (2 parities, 2 sums, gridDim.x)
  int* iters;                               // [0]: running total, [1 + item]: this item's iterations
  int item;
  int H, W, tile_rows, tiles_x, tiles;
  float rtol2;
  int maxiter;
};

// Sums a and b over the block in one fixed order; every thread gets them.
__device__ void sw_block_sum(double& a, double& b, double (*red)[kSwWarps]) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = 0.0;
  b = 0.0;
  for (int w = 0; w < kSwWarps; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
  __syncthreads();
}

// A grid-wide sum: the block's sums go to the half of `partials` of the
// epoch's parity (rewritten two epochs later, when every block has read
// it), one grid barrier, then every block adds all blocks' sums in the same
// fixed order.
__device__ void sw_grid_sum(double& a, double& b, unsigned epoch, const StreamArgs& s,
                            double (*red)[kSwWarps]) {
  sw_block_sum(a, b, red);
  const int G = gridDim.x;
  double* slot = s.partials + (long)2 * (epoch & 1) * G;
  if (threadIdx.x == 0) {
    slot[blockIdx.x] = a;
    slot[G + blockIdx.x] = b;
  }
  cg::this_grid().sync();
  a = 0.0;
  b = 0.0;
  for (int i = threadIdx.x; i < G; i += kSwThreads) {
    a += __ldcg(slot + i);
    b += __ldcg(slot + G + i);
  }
  sw_block_sum(a, b, red);
}

// The preconditioner at pixel g = (i, j): the 2x2 block's inverse from the
// coefficient planes, the Laplacian's diagonal from the four incident weights.
__device__ __forceinline__ void sw_precond(const StreamArgs& s, long g, int i, int j, float wvu_u, float wvu_v,
                                           float& i00, float& i01, float& i11) {
  const float du = __ldg(s.a11 + g) + diag4(__ldg(s.wuh + g), j > 0 ? __ldg(s.wuh + g - 1) : 0.0f,
                                            __ldg(s.wuv + g), i > 0 ? wvu_u : 0.0f);
  const float dv = __ldg(s.a22 + g) + diag4(__ldg(s.wvh + g), j > 0 ? __ldg(s.wvh + g - 1) : 0.0f,
                                            __ldg(s.wvv + g), i > 0 ? wvu_v : 0.0f);
  block_jacobi(du, dv, __ldg(s.a12 + g), i00, i01, i11);
}

// What sweep 1 loads at a pixel of a row (zeros off the image): the
// coefficients, r, p of the last iteration and x.
struct SwLoad {
  float a11, a12, a22, wuh, wvh, wuv, wvv, whl_u, whl_v, ru, rv, pou, pov;
  float2 x;
};

// What A p at a pixel still needs once p of its row is known: the data
// block's product with p, p, the weights its neighbours' terms take, the
// term of the row above (known once that row's p is) and x updated.
struct SwRow {
  float dpu, dpv, pu, pv, wuh, wvh, wuv, wvv, whl_u, whl_v, evu_u, evu_v;
  float2 x;
};

__device__ __forceinline__ SwLoad sw_load(const StreamArgs& s, const float* pou, const float* pov, int k, int i,
                                          int j, bool row_ok, bool want_x) {
  SwLoad l = {};
  if (!row_ok) return l;
  const long g = (long)i * s.W + j;
  l.a11 = __ldg(s.a11 + g);
  l.a12 = __ldg(s.a12 + g);
  l.a22 = __ldg(s.a22 + g);
  l.wuh = __ldg(s.wuh + g);
  l.wvh = __ldg(s.wvh + g);
  l.wuv = __ldg(s.wuv + g);
  l.wvv = __ldg(s.wvv + g);
  l.whl_u = j > 0 ? __ldg(s.wuh + g - 1) : 0.0f;
  l.whl_v = j > 0 ? __ldg(s.wvh + g - 1) : 0.0f;
  l.ru = __ldcg(s.ru + g);
  l.rv = __ldcg(s.rv + g);
  if (k > 0) {
    l.pou = __ldcg(pou + g);
    l.pov = __ldcg(pov + g);
    if (want_x) l.x = __ldcg(reinterpret_cast<const float2*>(s.x) + g);
  }
  return l;
}

// Sweep 1 of iteration k (alpha and beta of iteration k - 1): on each tile
// of the block, marching down its rows and the ring row above and below,
// p = z + beta p_old with z = M^-1 r recomputed from r and the coefficient
// planes (p = z at k = 0), also on the ring's columns; then, one row behind,
// A p, its share of p.Ap, and the deferred x += alpha p_old (x = 0 at
// k = 0).  Writes p (to the buffer of k's parity), A p and x on the tile.
// The loads of the next row are in flight while a row is computed.
__device__ double sw_sweep1(const StreamArgs& s, int k, float alpha, float beta, float (*sp)[2][kSwCols + 2]) {
  const int tid = threadIdx.x, H = s.H, W = s.W;
  const int off = tid < kSwCols ? tid : (tid == kSwCols ? -1 : kSwCols);  // column in the tile
  const int c = off + 1;                                                  // slot in a row of sp
  const bool lane = tid < kSwCols + 2;
  const float* pou_g = s.p[(k + 1) & 1][0];
  const float* pov_g = s.p[(k + 1) & 1][1];
  float* pu_g = s.p[k & 1][0];
  float* pv_g = s.p[k & 1][1];
  double pap = 0.0;
  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const int ty = t / s.tiles_x, tx = t - ty * s.tiles_x;
    const int i0 = ty * s.tile_rows, i1 = min(i0 + s.tile_rows, H);
    const int j = tx * kSwCols + off;
    const bool col = lane && j >= 0 && j < W;
    const bool inner = tid < kSwCols && j < W;
    float wuv_up = 0.0f, wvv_up = 0.0f;  // wuv, wvv of the row above the current one
    if (col && i0 >= 2) {
      wuv_up = __ldg(s.wuv + (long)(i0 - 2) * W + j);
      wvv_up = __ldg(s.wvv + (long)(i0 - 2) * W + j);
    }
    SwLoad pre = sw_load(s, pou_g, pov_g, k, i0 - 1, j, col && i0 >= 1, false);
    SwRow cur = {};
    for (int i = i0 - 1, slot = 0; i <= i1; ++i, slot = slot == 2 ? 0 : slot + 1) {
      const SwLoad l = pre;
      if (i < i1) pre = sw_load(s, pou_g, pov_g, k, i + 1, j, col && i + 1 < H, inner && i + 1 < i1);
      SwRow nxt = {};
      if (col && i >= 0 && i < H) {
        const float wvu_u = i > 0 ? wuv_up : 0.0f, wvu_v = i > 0 ? wvv_up : 0.0f;
        const float du = l.a11 + diag4(l.wuh, l.whl_u, l.wuv, wvu_u);
        const float dv = l.a22 + diag4(l.wvh, l.whl_v, l.wvv, wvu_v);
        float i00, i01, i11;
        block_jacobi(du, dv, l.a12, i00, i01, i11);
        const float zu = i00 * l.ru + i01 * l.rv;
        const float zv = i01 * l.ru + i11 * l.rv;
        nxt.pu = k == 0 ? zu : zu + beta * l.pou;
        nxt.pv = k == 0 ? zv : zv + beta * l.pov;
        nxt.dpu = l.a11 * nxt.pu + l.a12 * nxt.pv;
        nxt.dpv = l.a12 * nxt.pu + l.a22 * nxt.pv;
        nxt.wuh = l.wuh;
        nxt.wvh = l.wvh;
        nxt.wuv = l.wuv;
        nxt.wvv = l.wvv;
        nxt.whl_u = l.whl_u;
        nxt.whl_v = l.whl_v;
        nxt.evu_u = i > 0 ? wvu_u * (cur.pu - nxt.pu) : 0.0f;
        nxt.evu_v = i > 0 ? wvu_v * (cur.pv - nxt.pv) : 0.0f;
        if (k > 0) nxt.x = make_float2(l.x.x + alpha * l.pou, l.x.y + alpha * l.pov);
        wuv_up = l.wuv;
        wvv_up = l.wvv;
      }
      if (lane) {
        sp[slot][0][c] = nxt.pu;
        sp[slot][1][c] = nxt.pv;
      }
      __syncthreads();
      const int ii = i - 1;  // the row whose A p this step computes
      if (inner && ii >= i0) {
        const int ps = slot == 0 ? 2 : slot - 1;
        const float pu = cur.pu, pv = cur.pv;
        const float pur = j < W - 1 ? sp[ps][0][c + 1] : 0.0f, pvr = j < W - 1 ? sp[ps][1][c + 1] : 0.0f;
        const float pud = ii < H - 1 ? nxt.pu : 0.0f, pvd = ii < H - 1 ? nxt.pv : 0.0f;
        // (F^T diag(w) F p) in the twin's order ((eh + ev) - eh_left) - ev_up
        const float eh_u = cur.wuh * (pu - pur), ev_u = cur.wuv * (pu - pud);
        const float eh_v = cur.wvh * (pv - pvr), ev_v = cur.wvv * (pv - pvd);
        const float ehl_u = j > 0 ? cur.whl_u * (sp[ps][0][c - 1] - pu) : 0.0f;
        const float ehl_v = j > 0 ? cur.whl_v * (sp[ps][1][c - 1] - pv) : 0.0f;
        const float apu = cur.dpu + (((eh_u + ev_u) - ehl_u) - cur.evu_u);
        const float apv = cur.dpv + (((eh_v + ev_v) - ehl_v) - cur.evu_v);
        pap += (double)pu * apu + (double)pv * apv;
        const long g = (long)ii * W + j;
        s.apu[g] = apu;
        s.apv[g] = apv;
        pu_g[g] = pu;
        pv_g[g] = pv;
        reinterpret_cast<float2*>(s.x)[g] = cur.x;
      }
      cur = nxt;
    }
    __syncthreads();  // the next tile's first rows reuse sp
  }
  return pap;
}

// [lo, hi): this block's share of the H W pixels, a multiple of 4 long.
__device__ __forceinline__ void sw_range(long n, long& lo, long& hi) {
  const long chunk = ((n + gridDim.x - 1) / gridDim.x + 3) & ~3L;
  lo = min(n, (long)blockIdx.x * chunk);
  hi = min(n, lo + chunk);
}

// Sweep 2: r -= alpha A p, z = M^-1 r, and the shares of r.z and r.r.
__device__ __forceinline__ void sw_residual(const StreamArgs& s, long q, float alpha, double& rz, double& rr,
                                            float& ru, float& rv) {
  ru = __ldcg(s.ru + q) - alpha * __ldcg(s.apu + q);
  rv = __ldcg(s.rv + q) - alpha * __ldcg(s.apv + q);
  const float i01 = __ldcg(s.i01 + q);
  const float zu = __ldcg(s.i00 + q) * ru + i01 * rv;
  const float zv = i01 * ru + __ldcg(s.i11 + q) * rv;
  rz += (double)ru * zu + (double)rv * zv;
  rr += (double)ru * ru + (double)rv * rv;
}

__device__ void sw_sweep2(const StreamArgs& s, float alpha, double& rz, double& rr) {
  const long n = (long)s.H * s.W;
  long lo, hi;
  sw_range(n, lo, hi);
  rz = 0.0;
  rr = 0.0;
  if ((n & 3) == 0) {  // every plane 16-byte aligned: four pixels a load
    for (long q = lo + 4 * threadIdx.x; q < hi; q += 4 * kSwThreads) {
      const float4 ru = __ldcg(reinterpret_cast<const float4*>(s.ru + q));
      const float4 rv = __ldcg(reinterpret_cast<const float4*>(s.rv + q));
      const float4 au = __ldcg(reinterpret_cast<const float4*>(s.apu + q));
      const float4 av = __ldcg(reinterpret_cast<const float4*>(s.apv + q));
      const float4 m00 = __ldcg(reinterpret_cast<const float4*>(s.i00 + q));
      const float4 m01 = __ldcg(reinterpret_cast<const float4*>(s.i01 + q));
      const float4 m11 = __ldcg(reinterpret_cast<const float4*>(s.i11 + q));
      const float r_u[4] = {ru.x, ru.y, ru.z, ru.w}, r_v[4] = {rv.x, rv.y, rv.z, rv.w};
      const float a_u[4] = {au.x, au.y, au.z, au.w}, a_v[4] = {av.x, av.y, av.z, av.w};
      const float c00[4] = {m00.x, m00.y, m00.z, m00.w}, c01[4] = {m01.x, m01.y, m01.z, m01.w};
      const float c11[4] = {m11.x, m11.y, m11.z, m11.w};
      float o_u[4], o_v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o_u[e] = r_u[e] - alpha * a_u[e];
        o_v[e] = r_v[e] - alpha * a_v[e];
        const float zu = c00[e] * o_u[e] + c01[e] * o_v[e];
        const float zv = c01[e] * o_u[e] + c11[e] * o_v[e];
        rz += (double)o_u[e] * zu + (double)o_v[e] * zv;
        rr += (double)o_u[e] * o_u[e] + (double)o_v[e] * o_v[e];
      }
      *reinterpret_cast<float4*>(s.ru + q) = make_float4(o_u[0], o_u[1], o_u[2], o_u[3]);
      *reinterpret_cast<float4*>(s.rv + q) = make_float4(o_v[0], o_v[1], o_v[2], o_v[3]);
    }
  } else {
    for (long q = lo + threadIdx.x; q < hi; q += kSwThreads) {
      float ru, rv;
      sw_residual(s, q, alpha, rz, rr, ru, rv);
      s.ru[q] = ru;
      s.rv[q] = rv;
    }
  }
}

// The whole solve of one system: setup, then while the test holds sweep 1,
// a grid sum (p.Ap, so alpha), sweep 2, a grid sum (r.z and r.r, so beta
// and the test): two grid barriers an iteration; then the last x update.
__global__ void __launch_bounds__(kSwThreads, kSwMinBlocks) cg_stream(StreamArgs s) {
  __shared__ float sp[3][2][kSwCols + 2];  // p of three rows of the tile and its ring's columns
  __shared__ double red[2][kSwWarps];
  const int H = s.H, W = s.W;
  unsigned epoch = 0;

  // setup: the preconditioner's planes, r = b, and the shares of r.z and b.b
  double rz_d = 0.0, bb_d = 0.0;
  for (int i = blockIdx.x; i < H; i += gridDim.x) {
    for (int j = threadIdx.x; j < W; j += kSwThreads) {
      const long g = (long)i * W + j;
      float i00, i01, i11;
      sw_precond(s, g, i, j, i > 0 ? __ldg(s.wuv + g - W) : 0.0f, i > 0 ? __ldg(s.wvv + g - W) : 0.0f,
                 i00, i01, i11);
      s.i00[g] = i00;
      s.i01[g] = i01;
      s.i11[g] = i11;
      const float bu = __ldg(s.bu + g), bv = __ldg(s.bv + g);
      s.ru[g] = bu;
      s.rv[g] = bv;
      const float zu = i00 * bu + i01 * bv;
      const float zv = i01 * bu + i11 * bv;
      rz_d += (double)bu * zu + (double)bv * zv;
      bb_d += (double)bu * bu + (double)bv * bv;
    }
  }
  sw_grid_sum(rz_d, bb_d, ++epoch, s, red);
  float rz = (float)rz_d;
  float rr = (float)bb_d;
  const float tol2 = s.rtol2 * rr;

  int it = 0;
  float alpha = 0.0f, beta = 0.0f;
  while (it < s.maxiter && rr > tol2) {
    double pap_d = sw_sweep1(s, it, alpha, beta, sp), unused = 0.0;
    sw_grid_sum(pap_d, unused, ++epoch, s, red);
    const float pap = (float)pap_d;
    alpha = pap != 0.0f ? rz / pap : 0.0f;
    double rz_new_d, rr_d;
    sw_sweep2(s, alpha, rz_new_d, rr_d);
    sw_grid_sum(rz_new_d, rr_d, ++epoch, s, red);
    const float rz_new = (float)rz_new_d;
    rr = (float)rr_d;
    beta = rz != 0.0f ? rz_new / rz : 0.0f;
    rz = rz_new;
    ++it;
  }

  // x += alpha p of the last iteration (x = 0 if there was none)
  const long n = (long)H * W;
  long lo, hi;
  sw_range(n, lo, hi);
  const float* pu = s.p[(it + 1) & 1][0];
  const float* pv = s.p[(it + 1) & 1][1];
  float2* x = reinterpret_cast<float2*>(s.x);
  for (long q = lo + threadIdx.x; q < hi; q += kSwThreads) {
    float2 xv = make_float2(0.0f, 0.0f);
    if (it > 0) {
      xv = __ldcg(x + q);
      xv.x += alpha * __ldcg(pu + q);
      xv.y += alpha * __ldcg(pv + q);
    }
    x[q] = xv;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    s.iters[1 + s.item] = it;
    s.iters[0] += it;
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

// The streaming solve of B systems of coefficient planes (B, H, W) each, one
// cooperative launch an item, as cg_plan in ops/cuda/cg_kernel.py chooses
// it: `blocks` blocks (at most kSwMinBlocks an SM), tiles of `tile_rows`
// rows and kSwCols columns.  x: (B, H, W, 2) out; work: 11 planes (H, W),
// reused item after item; partials: 4 * blocks doubles; iters: 1 + B ints.
extern "C" int cg_stream_f32(const float* a11, const float* a12, const float* a22, const float* wuh,
                             const float* wuv, const float* wvh, const float* wvv, const float* bu,
                             const float* bv, float* x, float* work, double* partials, int* iters,
                             int B, int H, int W, float rtol2, int maxiter, int blocks, int tile_rows,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || blocks < 1 || tile_rows < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)H * W;
  StreamArgs s;
  float* planes[11];
  for (int q = 0; q < 11; ++q) planes[q] = work + q * n;
  s.ru = planes[0]; s.rv = planes[1]; s.apu = planes[2]; s.apv = planes[3];
  s.i00 = planes[4]; s.i01 = planes[5]; s.i11 = planes[6];
  s.p[0][0] = planes[7]; s.p[0][1] = planes[8]; s.p[1][0] = planes[9]; s.p[1][1] = planes[10];
  s.partials = partials;
  s.iters = iters;
  s.H = H; s.W = W; s.tile_rows = tile_rows;
  s.tiles_x = (W + kSwCols - 1) / kSwCols;
  s.tiles = s.tiles_x * ((H + tile_rows - 1) / tile_rows);
  s.rtol2 = rtol2; s.maxiter = maxiter;
  for (int item = 0; item < B; ++item) {
    s.a11 = a11 + item * n; s.a12 = a12 + item * n; s.a22 = a22 + item * n;
    s.wuh = wuh + item * n; s.wuv = wuv + item * n; s.wvh = wvh + item * n; s.wvv = wvv + item * n;
    s.bu = bu + item * n; s.bv = bv + item * n;
    s.x = x + 2 * item * n;
    s.item = item;
    void* kargs[] = {&s};
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)cg_stream, dim3((unsigned)blocks),
                                                  dim3(kSwThreads), kargs, 0,
                                                  static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
