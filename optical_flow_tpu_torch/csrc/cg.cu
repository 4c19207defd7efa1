// Whole block-Jacobi PCG solve of the coupled 2-field 5-point flow system,
// in one cooperative launch.  Replaces the Pallas kernel _cg_kernel /
// cg_solve_pallas (optical_flow_tpu/ops/pallas/cg_kernel.py).
//
// Bound on the H100: memory traffic and grid-wide synchronisation.  An
// iteration does ~60 flops per pixel against ~100 bytes of plane traffic;
// at the finest main-path level (388x584) the ~20 planes (18 MB) stay in
// the 50 MB L2, so an iteration costs a few L2 passes plus three grid
// barriers.  The design keeps the whole loop, its two dot products and the
// stopping test on the device: one launch per solve instead of ~10 launches
// and a host round trip per iteration.  Blocks walk the pixels in a
// grid-stride loop; each dot product is reduced per block, written to
// scratch, and after the barrier every block reduces the block partials in
// the same fixed order (no float atomics), so every block takes the same
// branch and the result repeats run to run.
//
// Semantics follow the plain twin (pcg_solve_split): x0 = 0, the test
// ||r||^2 > rtol^2 ||b||^2 before every iteration, at most maxiter
// iterations, a zero step where p.Ap == 0 or r.z == 0, and the per-pixel
// 2x2 block-Jacobi preconditioner with 1e-12 guards.
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
  int* iters;  // [0]: this solve's iteration count, [1]: running total
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
    s.iters[0] = it;
    s.iters[1] += it;
  }
}

}  // namespace

// Coefficient planes (H, W) each; x: (H, W, 2) out; work: 11 planes (H, W);
// partials: 4 * kMaxBlocks doubles; iters: 2 ints.
extern "C" int cg_solve_f32(const float* a11, const float* a12, const float* a22, const float* wuh,
                            const float* wuv, const float* wvh, const float* wvv, const float* bu,
                            const float* bv, float* x, float* work, double* partials, int* iters,
                            int H, int W, float rtol2, int maxiter, void* stream) {
  const long n = (long)H * W;
  CgArgs s;
  s.a11 = a11; s.a12 = a12; s.a22 = a22;
  s.wuh = wuh; s.wuv = wuv; s.wvh = wvh; s.wvv = wvv;
  s.bu = bu; s.bv = bv;
  s.x = x;
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
  void* kargs[] = {&s};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)cg_kernel, dim3((unsigned)blocks),
                                                dim3(kThreads), kargs, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
