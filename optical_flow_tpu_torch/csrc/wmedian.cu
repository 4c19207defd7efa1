// Colour-guided weighted median of both flow fields over (2h+1)^2 windows,
// by exact bisection over order-isomorphic int32 keys.  Replaces the Pallas
// kernel _wmedian_kernel / _wmedian_call
// (optical_flow_tpu/ops/pallas/wmedian_kernel.py).
//
// The weighted median of a window is the smallest key m whose summed
// weight S(m) (weights of samples with key <= m) reaches total/2.  Integer
// bisection finds m exactly; S only jumps at present keys, so the result is
// always one of the window's samples -- the sort + cumsum + first-crossing
// selection of the plain twin, without sorting.
//
// Bound on the H100, at the main path's finest level (388x584, hsz 7, C 3):
// operations, counted independently of the selection method.  Per pixel
// the 225 weights cost 3C + 5 = 14 operations each (channel differences
// squared and summed, the scale, expf, the occlusion product, the max, the
// running total), and selecting each field's weighted median costs a sort's
// K2 log2 K2 compares plus K2 adds for the running sum: ~7.1k operations
// per pixel, 1.6 G per call, 0.024 ms at the 67 TFLOP/s float32 peak.  The
// bytes (six padded 402x598 planes in, 388x584x2 out, 7.6 MB) take 2.3 us
// at 3.35 TB/s.  Bisection does more work than a sort (a compare and an add
// per sample, field and round, ~25k operations per pixel at 28 rounds) but
// keeps each lane's samples in registers and never reorders them.
//
// The first design gave each output pixel one thread whose 225 weights lived
// in shared memory: 115 KB per 128-pixel block, so one block and 4 warps per
// SM, ~40 cycles per (round, sample) step with the shared-memory latency
// exposed, and a fixed 32 rounds.  This design:
//  - G lanes own one output pixel (G a power of two: 8 at hsz 7, see
//    lanes_for).  Lane l holds the window samples o = s * G + l for
//    s < NS = ceil(K2 / G) as (key, weight) pairs in registers, so the
//    bisection loop does no memory traffic: a compare and a predicated add
//    per slot and round.
//  - A block stages only the window planes (the keys of u and v, encoded
//    once, occ and the guide) for its tile plus halo in shared memory, about
//    10 KB; registers set the occupancy, capped by __launch_bounds__ at 128
//    per thread for 16 warps per SM.  The fields run one after the other, so
//    only one field's keys are live beside the weights.
//  - The main path's 3-channel guide has its own kernel, with the channel
//    loop unrolled: the run-time-C kernel alone ran 19% slower at 388x584
//    (PERF.md).  Other channel counts read C at run time.
//  - Every sum (the total and each S(mid)) is a per-lane sum in slot order,
//    then a xor butterfly over the group: at each step both partners add
//    the same two values, so all G lanes hold bit-identical sums, the branch
//    on S >= total/2 is uniform in the group, and results repeat run to run.
//    No atomics.
//  - Each field's loop stops once hi = lo + 1.  That is where a fixed 32
//    rounds end too: from there mid = lo, S(lo) < total/2 and nothing
//    changes, so the early exit returns the 32-round result bit for bit.
//    On RubberWhale's main path a pixel's field needs 25-31 rounds.
//  - Blocks of 256 threads shrink, down to one warp, while the grid would
//    have fewer than two blocks per SM, so the coarse levels spread over the
//    card.
// The weights round as the plain twin's (--fmad=false, expf, no fast math)
// and are bit-identical to them.  The sums run in another order than the
// twin's sorted cumsum, so where S(m) lands within rounding of total/2 the
// result can be another sample that is a weighted median within the sums'
// rounding; chip_smoke.py checks that criterion.
// Windows wider than hsz 12 run wmedian_wide_kernel below: the same sums
// and bisection with one warp a pixel and its samples in shared memory.
#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHsz = 12;     // the widest window of the register kernel
constexpr int kMaxSlots = 29;     // register slots per lane at the default lane counts
constexpr int kThreads = 256;     // threads per block on large levels
constexpr int kMinThreads = 32;   // ... and the fewest, on small ones
constexpr int kMaxSmem = 232448;  // the H100's per-block opt-in limit

// Lanes per output pixel: the fewest (a power of two) that leave at most
// kMaxSlots window samples to each lane.  hsz 0-2: 1, 3: 2, 4: 4, 5-7: 8,
// 8-10: 16, 11-12: 32.
__host__ __device__ constexpr int lanes_for(int hsz) {
  int g = 1;
  while (((2 * hsz + 1) * (2 * hsz + 1) + g - 1) / g > kMaxSlots) g *= 2;
  return g;
}

__host__ __device__ constexpr int slots_for(int hsz, int lanes) {
  return ((2 * hsz + 1) * (2 * hsz + 1) + lanes - 1) / lanes;
}

// Blocks per SM that __launch_bounds__ asks for: 2 (<= 128 registers a
// thread) while a field's keys and the weights take at most 96 registers.
__host__ __device__ constexpr int min_blocks_for(int slots) { return 2 * slots <= 96 ? 2 : 1; }

struct Args {
  const float *u, *v, *occ, *guide;  // (B, Hp, Wp) x 3, (B, C, Hp, Wp)
  float* out;                        // (B, H, W, 2)
  int B, C, H, W;
  float inv_2s2;
};

__device__ __forceinline__ int encode_f32(float x) {
  const int b = __float_as_int(x);
  return b < 0 ? (~b) ^ INT_MIN : b;
}

__device__ __forceinline__ float decode_i32(int key) {
  return __int_as_float(key < 0 ? ~(key ^ INT_MIN) : key);
}

// The lanes of this thread's group within its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// Butterfly sum over the group: every lane ends with the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float s, unsigned mask) {
#pragma unroll
  for (int m = 1; m < G; m <<= 1) s = s + __shfl_xor_sync(mask, s, m);
  return s;
}

// Shared-memory window index of this lane's slot s (valid when o < K2).
template <int HSZ, int G>
__device__ __forceinline__ int slot_index(int s, int lane, int base, int WC) {
  constexpr int K = 2 * HSZ + 1;
  const int o = s * G + lane;
  return base + (o / K) * WC + o % K;
}

// This lane's keys of one field; lo and hi become the group's min - 1 and
// max.  Slots past the window hold INT_MAX, which no mid reaches.
template <int HSZ, int G, int NS>
__device__ __forceinline__ void load_keys(const int* keys, int (&key)[NS], int& lo, int& hi,
                                          int lane, int base, int WC, unsigned mask) {
  constexpr int K2 = (2 * HSZ + 1) * (2 * HSZ + 1);
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s * G + lane < K2) {
      key[s] = keys[slot_index<HSZ, G>(s, lane, base, WC)];
      lo = min(lo, key[s]);
      hi = max(hi, key[s]);
    } else {
      key[s] = INT_MAX;
    }
  }
  // S(lo) = 0 < total/2; a finite float never encodes to INT_MIN
  lo = __reduce_min_sync(mask, lo) - 1;
  hi = __reduce_max_sync(mask, hi);
}

// This lane's share of S(mid), summed in slot order.
template <int NS>
__device__ __forceinline__ float lane_below(const int (&key)[NS], const float (&w)[NS], int mid) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (key[i] <= mid) s = s + w[i];
  }
  return s;
}

// Bisection of one field: S(lo) < half <= S(hi) throughout.
template <int G, int NS>
__device__ __forceinline__ int bisect(const int (&key)[NS], const float (&w)[NS], int lo, int hi,
                                      float half, unsigned mask) {
  // hi - lo can exceed INT_MAX: compare it unsigned
  for (int round = 0; round < 32 && (unsigned)hi - (unsigned)lo > 1u; ++round) {
    const int mid = (lo & hi) + ((lo ^ hi) >> 1);  // floor((lo + hi) / 2), no overflow
    if (group_sum<G>(lane_below(key, w, mid), mask) >= half) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return hi;
}

// kC: the guide's channel count, or 0 to read it from a.C
template <int HSZ, int G, int kC>
__global__ void __launch_bounds__(kThreads, min_blocks_for(slots_for(HSZ, G)))
    wmedian_kernel(Args a, int tile_w, int tile_h) {
  constexpr int K2 = (2 * HSZ + 1) * (2 * HSZ + 1);
  constexpr int NS = slots_for(HSZ, G);
  const int C = kC > 0 ? kC : a.C;
  extern __shared__ float smem[];
  const int WC = tile_w + 2 * HSZ, WN = (tile_h + 2 * HSZ) * WC;
  const int Hp = a.H + 2 * HSZ, Wp = a.W + 2 * HSZ;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * tile_h, x0 = blockIdx.x * tile_w;

  int* ku_s = reinterpret_cast<int*>(smem);        // WN keys of u
  int* kv_s = ku_s + WN;                            // WN keys of v
  float* occ_s = reinterpret_cast<float*>(kv_s + WN);  // WN
  float* g_s = occ_s + WN;                          // C * WN
  for (int e = threadIdx.x; e < WN; e += blockDim.x) {
    const int r = e / WC, c = e - r * WC;
    const int gy = min(y0 + r, Hp - 1), gx = min(x0 + c, Wp - 1);
    const long gi = ((long)b * Hp + gy) * Wp + gx;
    ku_s[e] = encode_f32(a.u[gi]);
    kv_s[e] = encode_f32(a.v[gi]);
    occ_s[e] = a.occ[gi];
    for (int ch = 0; ch < C; ++ch) {
      g_s[ch * WN + e] = a.guide[(((long)b * C + ch) * Hp + gy) * Wp + gx];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & (G - 1);
  const int px = threadIdx.x / G;
  const int ty = px / tile_w, tx = px - ty * tile_w;
  const int y = y0 + ty, x = x0 + tx;
  if (y >= a.H || x >= a.W) return;  // the whole group leaves; no barrier follows
  const unsigned mask = group_mask<G>();
  const int base = ty * WC + tx;  // window index of offset (0, 0)
  const int center = base + HSZ * WC + HSZ;

  // weights max(exp(-sum_c dc^2 / 2s^2) * occ, 1e-10); 0 past the window
  float w[NS];
  float total = 0.0f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    w[s] = 0.0f;
    if (s * G + lane < K2) {
      const int e = slot_index<HSZ, G>(s, lane, base, WC);
      float cdiff = 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float d = g_s[ch * WN + e] - g_s[ch * WN + center];
        cdiff = cdiff + d * d;
      }
      w[s] = fmaxf(expf(-cdiff * a.inv_2s2) * occ_s[e], 1e-10f);
    }
    total = total + w[s];
  }
  const float half = group_sum<G>(total, mask) * 0.5f;

  // u, then v: the keys of one field at a time stay in registers
  int lo, hi;
  int key_u[NS];
  load_keys<HSZ, G, NS>(ku_s, key_u, lo, hi, lane, base, WC, mask);
  const int hi_u = bisect<G, NS>(key_u, w, lo, hi, half, mask);
  int key_v[NS];
  load_keys<HSZ, G, NS>(kv_s, key_v, lo, hi, lane, base, WC, mask);
  const int hi_v = bisect<G, NS>(key_v, w, lo, hi, half, mask);
  if (lane == 0) {
    reinterpret_cast<float2*>(a.out)[((long)b * a.H + y) * a.W + x] =
        make_float2(decode_i32(hi_u), decode_i32(hi_v));
  }
}

size_t smem_bytes(int tile_w, int tile_h, int hsz, int C) {
  return sizeof(float) * (size_t)(3 + C) * (tile_h + 2 * hsz) * (tile_w + 2 * hsz);
}

// The SM count, queried once: it only sizes the blocks, so a host with
// cards of different sizes still computes the same result on each.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

template <int HSZ, int G, int kC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int sms = sm_count();
  // 256 threads a block, halved while the grid has fewer than two blocks per
  // SM (or the window does not fit), down to one warp
  int threads = kThreads, tile_w = 0, tile_h = 0;
  size_t smem = 0;
  for (;; threads /= 2) {
    const int pixels = threads / G;
    tile_w = pixels >= 128 ? 16 : (pixels < 8 ? pixels : 8);
    tile_h = pixels / tile_w;
    smem = smem_bytes(tile_w, tile_h, HSZ, a.C);
    const long blocks = (long)((a.W + tile_w - 1) / tile_w) * ((a.H + tile_h - 1) / tile_h) * a.B;
    if (threads == kMinThreads || (blocks >= 2L * sms && smem <= (size_t)kMaxSmem)) break;
  }
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = wmedian_kernel<HSZ, G, kC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.W + tile_w - 1) / tile_w, (a.H + tile_h - 1) / tile_h, a.B);
  kernel<<<grid, threads, smem, stream>>>(a, tile_w, tile_h);
  return cudaGetLastError();
}

// Windows wider than kMaxHsz, whose samples do not fit in a group's
// registers: one warp a pixel, hsz read at run time.  Lane l owns the
// samples o = l + 32 s, as the register kernel's 32-lane groups do, and
// keeps their weights and one field's keys in a shared-memory strip of its
// warp's own (2 K2 words a warp, indexed by o, so the lanes of a warp hit
// distinct banks and no lane reads another's words: no barrier).  The
// window is read from global memory (L1 / L2), not staged.  Sums are per
// lane in slot order and then the xor butterfly, so the results repeat
// and the bisection is the register kernel's.
__global__ void __launch_bounds__(kThreads) wmedian_wide_kernel(Args a, int hsz, int warps) {
  extern __shared__ float smem[];
  const int K = 2 * hsz + 1, K2 = K * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* w_s = smem + (size_t)warp * 2 * K2;
  int* k_s = reinterpret_cast<int*>(w_s + K2);
  const long p = (long)blockIdx.x * warps + warp;
  if (p >= (long)a.H * a.W) return;  // the whole warp leaves; no barrier follows
  const int y = (int)(p / a.W), x = (int)(p - (long)y * a.W);
  const int Wp = a.W + 2 * hsz;
  const long plane = (long)(a.H + 2 * hsz) * Wp;
  const long item = (long)blockIdx.z * plane;  // the item's padded plane
  const float* guide = a.guide + (long)blockIdx.z * a.C * plane;
  const long center = (long)(y + hsz) * Wp + x + hsz;
  const unsigned mask = 0xffffffffu;

  float total = 0.0f;
  for (int o = lane; o < K2; o += 32) {
    const long e = (long)(y + o / K) * Wp + x + o % K;
    float cdiff = 0.0f;
    for (int ch = 0; ch < a.C; ++ch) {
      const float d = guide[ch * plane + e] - guide[ch * plane + center];
      cdiff = cdiff + d * d;
    }
    const float w = fmaxf(expf(-cdiff * a.inv_2s2) * a.occ[item + e], 1e-10f);
    w_s[o] = w;
    total = total + w;
  }
  const float half = group_sum<32>(total, mask) * 0.5f;

  int hi_f[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const float* field = f == 0 ? a.u : a.v;
    int lo = INT_MAX, hi = INT_MIN;
    for (int o = lane; o < K2; o += 32) {
      const int key = encode_f32(field[item + (long)(y + o / K) * Wp + x + o % K]);
      k_s[o] = key;
      lo = min(lo, key);
      hi = max(hi, key);
    }
    lo = __reduce_min_sync(mask, lo) - 1;  // S(lo) = 0 < total/2
    hi = __reduce_max_sync(mask, hi);
    for (int round = 0; round < 32 && (unsigned)hi - (unsigned)lo > 1u; ++round) {
      const int mid = (lo & hi) + ((lo ^ hi) >> 1);
      float s = 0.0f;
      for (int o = lane; o < K2; o += 32) {
        if (k_s[o] <= mid) s = s + w_s[o];
      }
      if (group_sum<32>(s, mask) >= half) {
        hi = mid;
      } else {
        lo = mid;
      }
    }
    hi_f[f] = hi;
  }
  if (lane == 0) {
    reinterpret_cast<float2*>(a.out)[((long)blockIdx.z * a.H + y) * a.W + x] =
        make_float2(decode_i32(hi_f[0]), decode_i32(hi_f[1]));
  }
}

// Warps (pixels) a block of the wide kernel: 8, fewer where their strips
// exceed the opt-in shared memory; 0 where one strip does.
int wide_warps(int hsz) {
  if (hsz > 1024) return 0;
  const size_t strip = sizeof(float) * 2 * (size_t)(2 * hsz + 1) * (2 * hsz + 1);
  return (int)std::min<size_t>(kThreads / 32, kMaxSmem / strip);
}

cudaError_t launch_wide(int hsz, const Args& a, cudaStream_t stream) {
  const int warps = wide_warps(hsz);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)(2 * hsz + 1) * (2 * hsz + 1) * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(wmedian_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long pixels = (long)a.H * a.W;
  const dim3 grid((unsigned)((pixels + warps - 1) / warps), 1, a.B);
  wmedian_wide_kernel<<<grid, 32 * warps, smem, stream>>>(a, hsz, warps);
  return cudaGetLastError();
}

template <int HSZ>
cudaError_t dispatch(int hsz, const Args& a, cudaStream_t stream) {
  if constexpr (HSZ > kMaxHsz) {
    return launch_wide(hsz, a, stream);
  } else {
    constexpr int G = lanes_for(HSZ);
    if (hsz == HSZ) return a.C == 3 ? launch<HSZ, G, 3>(a, stream) : launch<HSZ, G, 0>(a, stream);
    return dispatch<HSZ + 1>(hsz, a, stream);
  }
}

bool valid(int B, int C, int H, int W, int hsz) {
  return hsz >= 0 && wide_warps(hsz) > 0 && C >= 1 && B >= 1 && H >= 1 && W >= 1;
}

}  // namespace

// u, v, occ: (B, H+2h, W+2h) mirror-padded; guide: (B, C, H+2h, W+2h);
// out: (B, H, W, 2).  Returns a cudaError_t.
extern "C" int wmedian_f32(const float* u, const float* v, const float* occ, const float* guide,
                           float* out, int B, int C, int H, int W, int hsz, float inv_2sigma2,
                           void* stream) {
  if (!valid(B, C, H, W, hsz)) return (int)cudaErrorInvalidValue;
  const Args a{u, v, occ, guide, out, B, C, H, W, inv_2sigma2};
  return (int)dispatch<0>(hsz, a, static_cast<cudaStream_t>(stream));
}
