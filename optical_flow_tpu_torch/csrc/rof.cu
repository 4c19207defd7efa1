// Chambolle primal-dual ROF structure component.  Replaces the Pallas
// kernels rof_structure_2d_pallas and rof_structure_2d_tiled
// (optical_flow_tpu/ops/pallas/rof_kernel.py), which keep the image and the
// dual field in fast memory for all iterations.
//
// Bound on the H100: latency.  An iteration is ~28 flops per pixel, ~0.2 us
// at 2x388x584 at the float32 peak, so a launch per iteration (~7 us) costs
// more than the work.  Two kernels:
//
// * rof_resident (the main path's sizes): one cooperative launch for all
//   iterations.  Each block owns a band of rows of one image and keeps its
//   image, both dual planes (px, py) and the primal u in shared memory.  An
//   iteration computes u on the band and the row below, then the dual step
//   in place, publishes the band's first row (px, py) and last row (py) to
//   a buffer that alternates with the iteration's parity, waits at one grid
//   barrier and reads its neighbours' rows.  The output is written once.
// * rof_step / rof_final (too large for shared memory): one fused launch per
//   iteration that recomputes the primal at the three points it needs
//   (reading p at radius 1 left/up of each) and double-buffers (px, py).
//
// Every operation rounds as the plain PyTorch version does (the library is
// built with --fmad=false), in the same order, so both kernels equal it bit
// for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Planes {
  const float* im;
  const float* px;
  const float* py;
  int H, W;
};

// u = im + theta * div(p) at (i, j) of one image; div is the backward
// difference with zero boundary: (px - px[j-1]) + (py - py[i-1]).
__device__ __forceinline__ float primal(const Planes& s, long base, int i, int j,
                                        float theta) {
  const long k = base + (long)i * s.W + j;
  const float pxl = j > 0 ? s.px[k - 1] : 0.0f;
  const float pyu = i > 0 ? s.py[k - s.W] : 0.0f;
  const float div = (s.px[k] - pxl) + (s.py[k] - pyu);
  return s.im[k] + theta * div;
}

__global__ void rof_step(Planes s, float* __restrict__ px_out, float* __restrict__ py_out,
                         long n, float theta, float delta) {
  const long hw = (long)s.H * s.W;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const long base = (idx / hw) * hw;
    const long r = idx - base;
    const int i = (int)(r / s.W);
    const int j = (int)(r - (long)i * s.W);
    const float u = primal(s, base, i, j, theta);
    // forward-difference gradient, zero at the far boundary
    const float gx = j < s.W - 1 ? primal(s, base, i, j + 1, theta) - u : 0.0f;
    const float gy = i < s.H - 1 ? primal(s, base, i + 1, j, theta) - u : 0.0f;
    const float px = s.px[idx] + delta * gx;
    const float py = s.py[idx] + delta * gy;
    const float norm = fmaxf(sqrtf(px * px + py * py), 1.0f);
    px_out[idx] = px / norm;
    py_out[idx] = py / norm;
  }
}

__global__ void rof_final(Planes s, float* __restrict__ out, long n, float theta) {
  const long hw = (long)s.H * s.W;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const long base = (idx / hw) * hw;
    const long r = idx - base;
    const int i = (int)(r / s.W);
    const int j = (int)(r - (long)i * s.W);
    out[idx] = primal(s, base, i, j, theta);
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

// im: (B, H, W); p: 4 planes of (B, H, W) -- (px, py) of buffer 0, which the
// caller zeroes, then (px, py) of buffer 1; out: (B, H, W).
extern "C" int rof_structure_f32(const float* im, float* p, float* out, int B, int H, int W,
                                 float theta, int n_iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long n = (long)B * H * W;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (long)sms * 16 ? want : (long)sms * 16);
  const float delta = 1.0f / (4.0f * theta);
  float* buf[2][2] = {{p, p + n}, {p + 2 * n, p + 3 * n}};
  int cur = 0;
  for (int it = 0; it < n_iters; ++it) {
    Planes s{im, buf[cur][0], buf[cur][1], H, W};
    rof_step<<<blocks, kThreads, 0, st>>>(s, buf[1 - cur][0], buf[1 - cur][1], n, theta, delta);
    cur = 1 - cur;
  }
  Planes s{im, buf[cur][0], buf[cur][1], H, W};
  rof_final<<<blocks, kThreads, 0, st>>>(s, out, n, theta);
  return (int)cudaGetLastError();
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
