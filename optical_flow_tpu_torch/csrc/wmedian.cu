// Colour-guided weighted median of both flow fields over (2h+1)^2 windows,
// by exact bisection over order-isomorphic int32 keys.  Replaces the Pallas
// kernel _wmedian_kernel / wmedian_pallas
// (optical_flow_tpu/ops/pallas/wmedian_kernel.py).
//
// The weighted median of a window is the smallest key m whose summed
// weight S(m) (weights of samples with key <= m) reaches total/2.  32 rounds
// of integer bisection find m exactly; S only jumps at present keys, so the
// result is always one of the window's samples -- the sort + cumsum +
// searchsorted selection, without sorting.
//
// Bound on the H100: shared-memory bandwidth and issue.  Per pixel, the 225
// weights cost 225 expf once, then each field runs 32 rounds over the 225
// (key, weight) pairs: ~14k shared loads, compares and adds per pixel,
// against ~30 bytes of device memory.  The design: one thread per output
// pixel; a block stages the (tile + 2h)^2 windows of u and v (as keys), of
// occ and of the guide in shared memory, computes the 225 weights once into
// shared memory (laid out offset-major so a warp's loads hit consecutive
// banks), and then bisects each field with keys read from the window.
// Weights and partial sums are accumulated in offset order; every float
// operation rounds as the plain PyTorch version does (--fmad=false, expf),
// so the weights are bit-identical to the plain version's.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 16;  // output columns per block; rows = threads / kTileW
constexpr int kMaxHsz = 12;
constexpr int kMaxSmem = 232448;  // the H100's per-block opt-in limit

__device__ __forceinline__ int encode_f32(float x) {
  const int b = __float_as_int(x);
  return b < 0 ? (~b) ^ INT_MIN : b;
}

__device__ __forceinline__ float decode_i32(int key) {
  return __int_as_float(key < 0 ? ~(key ^ INT_MIN) : key);
}

// Weighted median of one field: keys of the window at `base`, weights w_s.
__device__ float bisect(const int* keys, const float* w_s, int T, int K2, int k, int WC, int base,
                        float half) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int o = 0; o < K2; ++o) {
    const int key = keys[base + (o / k) * WC + (o % k)];
    lo = min(lo, key);
    hi = max(hi, key);
  }
  lo -= 1;  // S(lo) < half; a finite float never encodes to INT_MIN
  for (int round = 0; round < 32; ++round) {
    const int mid = (lo & hi) + ((lo ^ hi) >> 1);  // floor((lo + hi) / 2), no overflow
    float S = 0.0f;
    int o = 0;
    for (int dy = 0; dy < k; ++dy) {
      const int row = base + dy * WC;
      for (int dx = 0; dx < k; ++dx, ++o) {
        if (keys[row + dx] <= mid) S = S + w_s[o * T + threadIdx.x];
      }
    }
    if (S >= half) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return decode_i32(hi);
}

__global__ void wmedian_kernel(const float* __restrict__ u, const float* __restrict__ v,
                               const float* __restrict__ occ, const float* __restrict__ guide,
                               float* __restrict__ out, int C, int H, int W, int hsz, float inv_2s2,
                               int tile_h) {
  extern __shared__ float smem[];
  const int k = 2 * hsz + 1, K2 = k * k;
  const int T = blockDim.x;
  const int WR = tile_h + 2 * hsz, WC = kTileW + 2 * hsz, WN = WR * WC;
  const int Hp = H + 2 * hsz, Wp = W + 2 * hsz;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * tile_h, x0 = blockIdx.x * kTileW;

  float* w_s = smem;                                         // K2 * T weights
  int* ku = reinterpret_cast<int*>(w_s + (size_t)K2 * T);    // WN keys of u
  int* kv = ku + WN;                                         // WN keys of v
  float* occ_s = reinterpret_cast<float*>(kv + WN);          // WN
  float* g_s = occ_s + WN;                                   // C * WN

  for (int e = threadIdx.x; e < WN; e += T) {
    const int r = e / WC, c = e - (e / WC) * WC;
    const int gy = min(y0 + r, Hp - 1), gx = min(x0 + c, Wp - 1);
    const long gi = ((long)b * Hp + gy) * Wp + gx;
    ku[e] = encode_f32(u[gi]);
    kv[e] = encode_f32(v[gi]);
    occ_s[e] = occ[gi];
    for (int ch = 0; ch < C; ++ch) {
      g_s[ch * WN + e] = guide[(((long)b * C + ch) * Hp + gy) * Wp + gx];
    }
  }
  __syncthreads();

  const int ty = threadIdx.x / kTileW, tx = threadIdx.x - ty * kTileW;
  const int base = ty * WC + tx;  // window index of offset (0, 0)
  const int center = base + hsz * WC + hsz;

  // weights max(exp(-sum_c dc^2 / 2s^2) * occ, 1e-10), summed in offset order
  float total = 0.0f;
  int o = 0;
  for (int dy = 0; dy < k; ++dy) {
    for (int dx = 0; dx < k; ++dx, ++o) {
      const int e = base + dy * WC + dx;
      float cdiff = 0.0f;
      for (int ch = 0; ch < C; ++ch) {
        const float d = g_s[ch * WN + e] - g_s[ch * WN + center];
        cdiff = cdiff + d * d;
      }
      const float w = fmaxf(expf(-cdiff * inv_2s2) * occ_s[e], 1e-10f);
      w_s[o * T + threadIdx.x] = w;
      total = total + w;
    }
  }
  const float half = total * 0.5f;

  const float mu = bisect(ku, w_s, T, K2, k, WC, base, half);
  const float mv = bisect(kv, w_s, T, K2, k, WC, base, half);
  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    const long oi = (((long)b * H + y) * W + x) * 2;
    out[oi] = mu;
    out[oi + 1] = mv;
  }
}

size_t smem_bytes(int threads, int hsz, int C) {
  const int k = 2 * hsz + 1;
  const int WN = (threads / kTileW + 2 * hsz) * (kTileW + 2 * hsz);
  return sizeof(float) * ((size_t)k * k * threads + (size_t)(3 + C) * WN);
}

}  // namespace

// u, v, occ: (B, H+2h, W+2h) mirror-padded; guide: (B, C, H+2h, W+2h);
// out: (B, H, W, 2).  Returns a cudaError_t.
extern "C" int wmedian_f32(const float* u, const float* v, const float* occ, const float* guide,
                           float* out, int B, int C, int H, int W, int hsz, float inv_2sigma2,
                           void* stream) {
  if (hsz < 0 || hsz > kMaxHsz || C < 1 || B < 1 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = 128;
  while (threads > 32 && smem_bytes(threads, hsz, C) > (size_t)kMaxSmem) threads /= 2;
  const size_t smem = smem_bytes(threads, hsz, C);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(wmedian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_h = threads / kTileW;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + tile_h - 1) / tile_h, B);
  wmedian_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, occ, guide, out, C, H, W, hsz, inv_2sigma2, tile_h);
  return (int)cudaGetLastError();
}
