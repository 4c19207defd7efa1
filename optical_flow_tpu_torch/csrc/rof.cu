// Chambolle primal-dual ROF structure component, one fused launch per
// iteration.  Replaces the Pallas kernels rof_structure_2d_pallas and
// rof_structure_2d_tiled (optical_flow_tpu/ops/pallas/rof_kernel.py).
//
// Bound on the H100: memory traffic.  An iteration is ~20 flops per pixel
// against 16 bytes read (image + the two dual fields) and 8 written, so it
// runs at the L2/HBM rate; at 388x584x2 the whole working set (5 planes,
// 9 MB) stays in the 50 MB L2 across the 100 launches.  The design fuses
// divergence, gradient and reprojection into one pass that recomputes the
// primal u at the three points it needs (reading p at radius 1 left/up of
// each), and double-buffers (px, py) so no launch reads what it writes.
// Every operation rounds as the plain PyTorch version does (the library
// is built with --fmad=false), so the two agree to the last bit or so.
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
