// Single-token GQA attention over a float or int8 KV cache, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:_kernel
// (pallas_call in flash_decode). For each query head row bh it computes
// softmax(q k^T / sqrt(hd)) v over the cache positions < kv_len of KV row
// bh / group; an int8 cache is dequantized on load with its per-row scale
// (k * k_scale, v * v_scale, in f32). kv_len is read from device memory
// (the counterpart of the TPU kernel's scalar prefetch), so one build serves
// every length without a host sync, and cache rows at or past it are never
// read. With kv_len = 0 every row is skipped and the output is 0, as the TPU
// kernel's (acc 0 over l clamped to 1e-20).
//
// What bounds it on the H100: bytes. It reads each live cache row once
// (2 * hd values and, int8, two scales) for 4 * group * hd flops, about
// group / 2 flops per byte at bf16, far below the card's ~20 f32 flops per
// byte. The TPU grid is (query rows, key tiles), so each cache row is
// streamed once per query head; here:
//   * a block serves all `group` query heads of one KV row, so a cache row
//     is read once per launch, not group times;
//   * the rows of a KV row are split over blocks (a multiple of 64 rows
//     each, enough splits to give the card ~264 blocks: at the serving
//     shape, 32 KV rows x 512 positions, 8 splits of 64 rows, 256 blocks
//     for 132 SMs, where one block per KV row would leave 100 SMs idle);
//     each block walks its rows in 64-row chunks staged in shared memory
//     (dequantized to f32), keeps the running max, sum and accumulator of
//     its heads, and publishes them as a partial; the last block of a KV
//     row to finish (an atomic ticket) merges the partials in split order
//     and writes the output, and leaves the ticket zeroed again.
// f32 FMAs throughout; vector loads, a shorter split for short kv_len and
// overlapping the staging with the math are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;            // cache rows staged per pass
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// q, out and scales come in f32 or bf16, chosen at run time (uniform branch)
__device__ __forceinline__ float load_any(const void* p, int dtype, size_t i) {
  return dtype == kF32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline int smem_floats(int G, int hd) {
  return G * hd                 // queries
         + kChunk * (hd + 1)    // staged K rows (padded)
         + kChunk * hd          // staged V rows
         + G * kChunk           // scores / probabilities
         + G * hd               // accumulator
         + 3 * G;               // running max, sum, rescale
}

struct Args {
  const void* q;        // (BKV * G, hd), q_dtype
  const void* k;        // (BKV, S, hd)
  const void* v;
  const void* ks;       // (BKV, S, 1) int8 caches only, scale_dtype
  const void* vs;
  const int* kv_len;    // device scalar, or null: use kv_len_host
  void* out;            // (BKV * G, hd), q_dtype
  float* ws;            // (BKV, splits, 2G + G*hd) partial max, sum, acc
  int* tickets;         // (BKV,) zeroed; left zeroed
  int kv_len_host, G, S, hd, q_dtype, scale_dtype, splits, rows_per_split;
  float scale;
};

template <typename TC, bool QUANT>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Args a) {
  extern __shared__ float sm[];
  const int G = a.G, hd = a.hd, S = a.S;
  const int row = blockIdx.x, split = blockIdx.y;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  float* q_s = sm;
  float* k_s = q_s + G * hd;
  float* v_s = k_s + kChunk * (hd + 1);
  float* p_s = v_s + kChunk * hd;
  float* acc = p_s + G * kChunk;
  float* m_s = acc + G * hd;
  float* l_s = m_s + G;
  float* al_s = l_s + G;

  const int n = min(max(a.kv_len ? *a.kv_len : a.kv_len_host, 0), S);
  const size_t qoff = (size_t)row * G * hd;
  for (int i = t; i < G * hd; i += kThreads) {
    q_s[i] = load_any(a.q, a.q_dtype, qoff + i);
    acc[i] = 0.f;
  }
  for (int g = t; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const TC* kc = static_cast<const TC*>(a.k) + (size_t)row * S * hd;
  const TC* vc = static_cast<const TC*>(a.v) + (size_t)row * S * hd;
  const int r_end = min(n, (split + 1) * a.rows_per_split);
  // only rows < kv_len are staged: every staged column is live
  for (int c0 = split * a.rows_per_split; c0 < r_end; c0 += kChunk) {
    const int nc = min(kChunk, r_end - c0);
    for (int i = t; i < nc * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const size_t idx = (size_t)(c0 + j) * hd + d;
      float kv = to_f32(kc[idx]), vv = to_f32(vc[idx]);
      if constexpr (QUANT) {
        const size_t si = (size_t)row * S + c0 + j;
        kv *= load_any(a.ks, a.scale_dtype, si);
        vv *= load_any(a.vs, a.scale_dtype, si);
      }
      k_s[j * (hd + 1) + d] = kv;
      v_s[j * hd + d] = vv;
    }
    __syncthreads();
    for (int i = t; i < G * nc; i += kThreads) {
      const int g = i / nc, j = i % nc;
      const float* qg = q_s + g * hd;
      const float* kr = k_s + j * (hd + 1);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kr[d], s);
      p_s[g * kChunk + j] = s * a.scale;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kChunk;
      float mx = kNegInf;
      for (int j = lane; j < nc; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nc; j += 32) {
        const float e = expf(pg[j] - m_new);
        pg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int o = t; o < G * hd; o += kThreads) {
      const int g = o / hd, d = o % hd;
      const float* pg = p_s + g * kChunk;
      float v = acc[o] * al_s[g];
      for (int j = 0; j < nc; ++j) v = fmaf(pg[j], v_s[j * hd + d], v);
      acc[o] = v;
    }
    __syncthreads();
  }

  // publish this block's partial; the last block of the KV row merges
  const int stride = 2 * G + G * hd;
  float* part = a.ws + ((size_t)row * a.splits + split) * stride;
  for (int g = t; g < G; g += kThreads) {
    part[g] = m_s[g];
    part[G + g] = l_s[g];
  }
  for (int o = t; o < G * hd; o += kThreads) part[2 * G + o] = acc[o];
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&a.tickets[row], 1) == a.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const float* parts = a.ws + (size_t)row * a.splits * stride;
  for (int g = t; g < G; g += kThreads) {
    float m = kNegInf;
    for (int sp = 0; sp < a.splits; ++sp) m = fmaxf(m, __ldcg(parts + sp * stride + g));
    float l = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      l += __ldcg(parts + sp * stride + G + g) * expf(__ldcg(parts + sp * stride + g) - m);
    m_s[g] = m;
    l_s[g] = l;
  }
  __syncthreads();
  for (int o = t; o < G * hd; o += kThreads) {
    const int g = o / hd;
    float v = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      v += __ldcg(parts + sp * stride + 2 * G + o) *
           expf(__ldcg(parts + sp * stride + g) - m_s[g]);
    v /= fmaxf(l_s[g], 1e-20f);
    if (a.q_dtype == kF32)
      static_cast<float*>(a.out)[qoff + o] = v;
    else
      static_cast<__nv_bfloat16*>(a.out)[qoff + o] = __float2bfloat16_rn(v);
  }
  if (t == 0) a.tickets[row] = 0;  // ready for the next launch
}

template <typename TC, bool QUANT>
int launch_typed(const Args& a, int BKV, cudaStream_t st) {
  auto kern = flash_decode_kernel<TC, QUANT>;
  const int smem = smem_floats(a.G, a.hd) * (int)sizeof(float);
  // raised on every launch (a cheap call) to this launch's need; past the
  // block's 227 KB it fails and the launch is refused
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(BKV, a.splits), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (BKV * G, hd) in q_dtype (0 f32, 1 bf16); k, v: (BKV, S, hd) in
// cache_dtype (0 f32, 1 bf16, 2 int8); ks, vs: (BKV, S, 1) in scale_dtype
// (int8 caches only); kv_len: an int32 on the device, or null for
// kv_len_host. ws: BKV * splits * (2G + G*hd) floats; tickets: BKV zeroed
// ints. Rows [sp * rows_per_split, (sp + 1) * rows_per_split) go to split
// sp; rows_per_split a multiple of 64. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_decode_launch(
    const void* q, int q_dtype, const void* k, const void* v, int cache_dtype,
    const void* ks, const void* vs, int scale_dtype, const int* kv_len,
    int kv_len_host, void* out, float* ws, int* tickets, int BKV, int G,
    int S, int hd, int splits, int rows_per_split, float scale,
    void* stream) {
  if (G < 1 || hd < 1 || splits < 1 || rows_per_split % kChunk != 0 ||
      splits > 65535 || (long long)splits * rows_per_split < S)
    return (int)cudaErrorInvalidValue;
  if (BKV == 0) return (int)cudaGetLastError();
  Args a{q, k, v, ks, vs, kv_len, out, ws, tickets, kv_len_host, G, S, hd,
         q_dtype, scale_dtype, splits, rows_per_split, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_dtype == kF32) return launch_typed<float, false>(a, BKV, st);
  if (cache_dtype == kBF16) return launch_typed<__nv_bfloat16, false>(a, BKV, st);
  return launch_typed<int8_t, true>(a, BKV, st);
}
