// Chambolle primal-dual ROF structure component.  Replaces the Pallas
// kernels rof_structure_2d_pallas and rof_structure_2d_tiled / _rof_tiled_call
// (optical_flow_tpu/ops/pallas/rof_kernel.py), which keep the image and the
// dual field in fast memory for all iterations.
//
// An iteration is ~28 flops per pixel and one stencil exchange each way, so
// the bound is the traffic between iterations, not arithmetic.  Two kernels:
//
// * rof_resident (the main path's sizes): one cooperative launch for all
//   iterations.  Each block owns a band of rows of one image and keeps its
//   image, both dual planes (px, py) and the primal u in shared memory.  An
//   iteration computes u on the band and the row below, then the dual step
//   in place, publishes the band's first row (px, py) and last row (py) to
//   a buffer that alternates with the iteration's parity, waits at one grid
//   barrier and reads its neighbours' rows.  The output is written once.
// * rof_tiled (images too large for shared memory; the counterpart of
//   _rof_tiled_call): overlap-and-discard tiling, temporally blocked.  A
//   block loads a window of kWinRows x kWinCols pixels of one image (its
//   tile and a halo of h pixels each side), runs k <= h iterations on chip
//   and writes (px, py) of the tile only.  The dual step at a pixel reads
//   the primal one pixel right and down, and the primal reads p one pixel
//   left and up, so the region that is exact shrinks by one pixel a side an
//   iteration: after k iterations everything at least k pixels from the
//   window's edge is, the tile included.  The zero boundary applies at the
//   image's true edges only (no pixel inside the image ever reads one
//   outside it), never at a window's edge.  A call is `passes` launches:
//   the first reads no dual field (it is zero), each writes (px, py) to the
//   other of two buffers than it read, so no block reads what another
//   writes, and the last (k <= h - 1, since the primal reads p one pixel
//   further) writes u = im + theta div p instead.  Per pixel a thread keeps
//   px, py and u of kRowsPerThread rows of one column in registers; the
//   image, px and u sit in shared memory for the neighbours' reads, py of
//   each strip's last row for the strip below.
//
// Every operation rounds as the plain PyTorch version does (the library is
// built with --fmad=false), in the same order, so both kernels equal it bit
// for bit.  Where |p|^2 <= 1 the norm is 1 and the division by it, exact,
// is skipped.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------------------ tiled

constexpr int kTiledThreads = 1024;
constexpr int kWinCols = 128;                          // one thread a column
constexpr int kStrips = kTiledThreads / kWinCols;      // 8 strips of rows
constexpr int kRowsPerThread = 12;
constexpr int kWinRows = kStrips * kRowsPerThread;     // 96

struct TiledArgs {
  const float* im;      // (B, H, W)
  const float* px_in;   // the dual field the pass starts from; null on the first pass
  const float* py_in;
  float* px_out;        // where the pass leaves it; null on the last pass
  float* py_out;
  float* out;           // u = im + theta div p, on the last pass only
  int H, W, halo, tiles_x, tiles_per_image, k;
  float theta, delta;
};

// Dynamic shared memory: the image, px and u of the window, then py of each
// strip's last row.
__global__ void __launch_bounds__(kTiledThreads, 1) rof_tiled(TiledArgs s) {
  extern __shared__ float smem[];
  float* sim = smem;
  float* spx = sim + kWinRows * kWinCols;
  float* su = spx + kWinRows * kWinCols;
  float* spy = su + kWinRows * kWinCols;  // (kStrips, kWinCols)
  const int tid = threadIdx.x, b = tid % kWinCols, st = tid / kWinCols;
  const int img = blockIdx.x / s.tiles_per_image, t = blockIdx.x - img * s.tiles_per_image;
  const int ty = t / s.tiles_x, tx = t - ty * s.tiles_x;
  const int h = s.halo, H = s.H, W = s.W;
  const int tr = kWinRows - 2 * h, tc = kWinCols - 2 * h;  // the tile
  const int gi0 = ty * tr - h + st * kRowsPerThread;       // this strip's first image row
  const int gj = tx * tc - h + b;                          // this thread's image column
  const long base = (long)img * H * W;
  const bool col_in = gj >= 0 && gj < W;
  const bool has_left = gj > 0 && b > 0, has_right = gj < W - 1 && b < kWinCols - 1;

  float px[kRowsPerThread], py[kRowsPerThread], u[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int gi = gi0 + r, a = st * kRowsPerThread + r;
    const bool in = col_in && gi >= 0 && gi < H;
    const long g = base + (long)gi * W + gj;
    sim[a * kWinCols + b] = in ? s.im[g] : 0.0f;
    px[r] = in && s.px_in ? s.px_in[g] : 0.0f;
    py[r] = in && s.py_in ? s.py_in[g] : 0.0f;
    spx[a * kWinCols + b] = px[r];
    if (r == kRowsPerThread - 1) spy[st * kWinCols + b] = py[r];
  }
  __syncthreads();

  // u = im + theta div p on the thread's rows; div is the backward
  // difference with zero boundary: (px - px[j-1]) + (py - py[i-1])
  auto primal = [&]() {
    float pyu = st > 0 ? spy[(st - 1) * kWinCols + b] : 0.0f;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int a = st * kRowsPerThread + r;
      const float pxl = has_left ? spx[a * kWinCols + b - 1] : 0.0f;
      const float pyu_r = gi0 + r > 0 ? pyu : 0.0f;
      u[r] = sim[a * kWinCols + b] + s.theta * ((px[r] - pxl) + (py[r] - pyu_r));
      pyu = py[r];
    }
  };

  for (int it = 0; it < s.k; ++it) {
    primal();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) su[(st * kRowsPerThread + r) * kWinCols + b] = u[r];
    __syncthreads();
    // the dual step: forward-difference gradient, zero at the far boundary
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int a = st * kRowsPerThread + r, gi = gi0 + r;
      const float gx = gj < W - 1 ? (has_right ? su[a * kWinCols + b + 1] : u[r]) - u[r] : 0.0f;
      float ud = u[r];
      if (r < kRowsPerThread - 1)
        ud = u[r + 1];
      else if (st < kStrips - 1)
        ud = su[(a + 1) * kWinCols + b];
      const float gy = gi < H - 1 ? ud - u[r] : 0.0f;
      float pxn = px[r] + s.delta * gx;
      float pyn = py[r] + s.delta * gy;
      const float n2 = pxn * pxn + pyn * pyn;
      if (n2 > 1.0f) {  // norm = max(sqrt(n2), 1) = sqrt(n2); else norm = 1
        const float norm = sqrtf(n2);
        pxn = pxn / norm;
        pyn = pyn / norm;
      }
      px[r] = pxn;
      py[r] = pyn;
      spx[a * kWinCols + b] = pxn;
    }
    spy[st * kWinCols + b] = py[kRowsPerThread - 1];
    __syncthreads();
  }

  const bool col_tile = col_in && b >= h && b < h + tc;
  if (s.out) primal();
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int a = st * kRowsPerThread + r, gi = gi0 + r;
    if (!col_tile || a < h || a >= h + tr || gi >= H) continue;
    const long g = base + (long)gi * W + gj;
    if (s.out) {
      s.out[g] = u[r];
    } else {
      s.px_out[g] = px[r];
      s.py_out[g] = py[r];
    }
  }
}

// ---------------------------------------------------------------- resident

constexpr int kRofThreads = 1024;

struct RofArgs {
  const float* im;
  float* halo;      // (2 parities, blocks, 3, W): first-row px, first-row py, last-row py
  float* out;
  int H, W, per_image;  // bands per image
  float theta, delta;
  int n_iters;
};

// rows [row0, row0 + rows) of band b of nb: the first H % nb bands take one
// row more (band_bounds in ops/cuda/cg_kernel.py)
__device__ __forceinline__ void band_of(int b, int nb, int H, int& row0, int& rows) {
  const int base = H / nb, extra = H % nb;
  rows = base + (b < extra ? 1 : 0);
  row0 = b * base + (b < extra ? b : extra);
}

// One block per band of rows of one image.  Shared memory (floats): the
// image and px on the band and the row below, (rows + 1) W each; py with
// the row above and the row below, (rows + 2) W; the primal u on the band
// and the row below, (rows + 1) W.
__global__ void __launch_bounds__(kRofThreads, 1) rof_resident(RofArgs s) {
  extern __shared__ float smem[];
  const int W = s.W, H = s.H, b = blockIdx.x, tid = threadIdx.x;
  const int img = b / s.per_image;
  int row0, rows;
  band_of(b - img * s.per_image, s.per_image, H, row0, rows);
  const bool above = row0 > 0, below = row0 + rows < H;
  const int ext = (rows + (below ? 1 : 0)) * W;  // the pixels whose u the band needs
  const long base = ((long)img * H + row0) * W;
  float* sim = smem;
  float* spx = sim + (rows + 1) * W;
  float* spy = spx + (rows + 1) * W;  // row r + 1 holds band row r
  float* su = spy + (rows + 2) * W;
  for (int q = tid; q < (rows + 1) * W; q += kRofThreads) {
    sim[q] = q < ext ? s.im[base + q] : 0.0f;
    spx[q] = 0.0f;
  }
  for (int q = tid; q < (rows + 2) * W; q += kRofThreads) spy[q] = 0.0f;
  __syncthreads();
  // a thread's pixels q = tid + k * kRofThreads as (band row il, column j),
  // advanced without a division
  const int il0 = tid / W, j0 = tid - il0 * W;
  const int dil = kRofThreads / W, dj = kRofThreads - dil * W;
  auto next = [=](int& il, int& j) {
    il += dil;
    j += dj;
    if (j >= W) {
      j -= W;
      ++il;
    }
  };

  for (int it = 0; it < s.n_iters; ++it) {
    // u = im + theta div p, div the backward difference with zero boundary
    for (int q = tid, il = il0, j = j0; q < ext; q += kRofThreads, next(il, j)) {
      const float pxl = j > 0 ? spx[q - 1] : 0.0f;
      const float pyu = row0 + il > 0 ? spy[q] : 0.0f;
      const float div = (spx[q] - pxl) + (spy[q + W] - pyu);
      su[q] = sim[q] + s.theta * div;
    }
    __syncthreads();
    // the dual step in place; the rows the neighbours need go out
    float* hb = s.halo + ((long)(it & 1) * gridDim.x + b) * 3 * W;
    for (int q = tid, il = il0, j = j0; q < rows * W; q += kRofThreads, next(il, j)) {
      const float u = su[q];
      const float gx = j < W - 1 ? su[q + 1] - u : 0.0f;
      const float gy = row0 + il < H - 1 ? su[q + W] - u : 0.0f;
      const float px = spx[q] + s.delta * gx;
      const float py = spy[q + W] + s.delta * gy;
      const float norm = fmaxf(sqrtf(px * px + py * py), 1.0f);
      const float pxn = px / norm, pyn = py / norm;
      spx[q] = pxn;
      spy[q + W] = pyn;
      if (il == 0) {
        hb[j] = pxn;
        hb[W + j] = pyn;
      }
      if (il == rows - 1) hb[2 * W + j] = pyn;
    }
    cooperative_groups::this_grid().sync();
    const float* hp = s.halo + (long)(it & 1) * gridDim.x * 3 * W;
    for (int j = tid; j < W; j += kRofThreads) {
      if (above) spy[j] = __ldcg(&hp[((long)(b - 1) * 3 + 2) * W + j]);
      if (below) {
        spx[rows * W + j] = __ldcg(&hp[((long)(b + 1) * 3 + 0) * W + j]);
        spy[(rows + 1) * W + j] = __ldcg(&hp[((long)(b + 1) * 3 + 1) * W + j]);
      }
    }
    __syncthreads();
  }
  for (int q = tid, il = il0, j = j0; q < rows * W; q += kRofThreads, next(il, j)) {
    const float pxl = j > 0 ? spx[q - 1] : 0.0f;
    const float pyu = row0 + il > 0 ? spy[q] : 0.0f;
    const float div = (spx[q] - pxl) + (spy[q + W] - pyu);
    s.out[base + q] = sim[q] + s.theta * div;
  }
}

}  // namespace

// The tiled solve of B (H, W) images, as rof_plan in ops/cuda/rof_kernel.py
// chooses it: a halo of `halo` pixels (the tile is the window less the halo
// each side) and `passes` launches, pass q running n_iters / passes
// iterations, one more for the first n_iters % passes (so the last runs at
// most halo - 1).  p: (px, py) of two buffers, 4 planes of (B, H, W), none
// read before it is written (none used if passes is 1); out: (B, H, W);
// smem: the dynamic shared memory a block.
extern "C" int rof_tiled_f32(const float* im, float* p, float* out, int B, int H, int W, float theta,
                             int n_iters, int halo, int passes, int smem, void* stream) {
  const int tr = kWinRows - 2 * halo, tc = kWinCols - 2 * halo;
  const int per = passes > 0 ? n_iters / passes : 0, extra = passes > 0 ? n_iters % passes : 0;
  if (B < 1 || H < 1 || W < 1 || n_iters < 0 || passes < 1 || tr < 1 || tc < 1 || per + (extra > 0) > halo ||
      per > halo - 1)
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)rof_tiled;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long n = (long)B * H * W;
  const int tiles_x = (W + tc - 1) / tc, tiles_y = (H + tr - 1) / tr;
  float* buf[2][2] = {{p, p + n}, {p + 2 * n, p + 3 * n}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int q = 0; q < passes; ++q) {
    const bool last = q == passes - 1;
    TiledArgs s{im,
                q > 0 ? buf[(q - 1) & 1][0] : nullptr,
                q > 0 ? buf[(q - 1) & 1][1] : nullptr,
                last ? nullptr : buf[q & 1][0],
                last ? nullptr : buf[q & 1][1],
                last ? out : nullptr,
                H, W, halo, tiles_x, tiles_x * tiles_y, per + (q < extra ? 1 : 0),
                theta, 1.0f / (4.0f * theta)};
    rof_tiled<<<B * tiles_x * tiles_y, kTiledThreads, smem, st>>>(s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The resident solve: per_image bands of rows for each of the B images, one
// block each, `smem` bytes of dynamic shared memory, as rof_plan in
// ops/cuda/rof_kernel.py chooses them.  halo: 2 * B * per_image * 3 * W
// floats; out: (B, H, W).
extern "C" int rof_resident_f32(const float* im, float* halo, float* out, int B, int H, int W,
                                float theta, int n_iters, int per_image, int smem, void* stream) {
  if (per_image < 1 || per_image > H) return (int)cudaErrorInvalidValue;
  RofArgs s{im, halo, out, H, W, per_image, theta, 1.0f / (4.0f * theta), n_iters};
  const void* fn = (const void*)rof_resident;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  void* kargs[] = {&s};
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(fn, dim3(B * per_image), dim3(kRofThreads), kargs, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
