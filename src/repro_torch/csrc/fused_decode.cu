// Fused one-token decode of one attention layer, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:_decode_kernel
// (pallas_call in _decode_pallas, called through fused_decode_step). Per slot
// it computes the width-gated QKV projection in f32 from the f32 master
// weights, RoPE, the optional int8 absmax round trip of the new K/V, an
// online-softmax decode over the cache walked through a (B, P) page table,
// the extension column for the new token, and the width-gated output
// projection.
//
// What bounds it on the H100: bytes. At TinyLlama width one layer reads
// 21 MB of f32 QKV weights, 16.8 MB of f32 output weights and, per slot,
// its live cache rows; the flops are 2 per weight element per slot. The TPU
// kernel runs one grid row per slot and loads the full wq/wk/wv/wo for every
// row (fused_decode.py:553-557), which at B = 8 would read the weights 8
// times. Here the layer is three launches, each reading its bytes once:
//   (a) fused_qkv_launch: the three projections as one gated skinny product
//       (gemv.cuh) over all slots, f32 out, no weight rounding;
//   (b) fused_attn_launch (this file): blocks over (slot, KV head, range of
//       cache rows). Each applies RoPE to its head's queries and walks its
//       rows once in 64-row chunks staged in shared memory, keeping the
//       running max, sum and accumulator there, and writes them as a
//       partial. The last block of a (slot, head) to finish (an atomic
//       ticket) merges the partials in row order with the extension column,
//       applies the quantize round trip to the new K/V, and writes the new
//       K/V into the cache. Splitting the rows keeps the card busy: one
//       block per (slot, head) is only B * KV = 32 blocks at TinyLlama width;
//   (c) the output projection through the morph_matmul kernel with
//       active_k = a_q (launched by the Python wrapper).
// Traps kept from the TPU kernel: the running max starts at -1e30 and masked
// probabilities are zeroed explicitly (a fully masked chunk would otherwise
// add exp(0) = 1); the slot's own cache column is masked and the extension
// stands in for it; the write-back happens only after every block of the
// (slot, head) has read its rows. Quantization: scale = absmax / 127, values
// rounded half-to-even (rintf), scales stored as bf16, and the extension
// attends with the bf16-rounded scale.
#include <math.h>

#include "gemv.cuh"

namespace {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kChunk = 64;            // cache rows staged per pass
constexpr float kNegInf = -1e30f;     // running-max init (KERNEL_NEG_INF)

enum CacheType : int { kCacheF32 = 0, kCacheBF16 = 1, kCacheI8 = 2 };

__device__ __forceinline__ float cache_f32(float v) { return v; }
__device__ __forceinline__ float cache_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float cache_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const int8_t*) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(int8_t* p, float v) { *p = (int8_t)v; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct AttnArgs {
  const float* q;      // (B, H*hd) gated projections, before RoPE
  const float* k;      // (B, KV*hd)
  const float* v;      // (B, KV*hd)
  void* kc;            // pool (n_pages, bk, KV, hd)
  void* vc;
  __nv_bfloat16* ks;   // (n_pages, bk, KV, 1) scales, int8 caches only
  __nv_bfloat16* vs;
  const int* table;    // (B, P) physical page of each logical page
  const int* pos;      // (B,) absolute position of the new token
  float* out;          // (B, H*hd) attention output, before the out proj
  float* ws;           // (B*KV, splits, 2G + G*hd) partial max, sum, acc
  int* tickets;        // (B*KV,) zeroed; left zeroed
  int B, H, KV, hd, P, bk, window, use_rope;
  int splits, rows_per_split;  // rows_per_split: a multiple of kChunk
  float rope_coef;     // log(theta) / (hd / 2)
  float scale;         // 1 / sqrt(hd)
};

// Shared-memory floats for one block (launch_attn sizes the launch by it).
__host__ __device__ inline int attn_smem_floats(int G, int hd) {
  return G * hd          // q
         + 4 * hd        // new k, v (attended) and their stored values
         + kChunk * (hd + 1) + kChunk * hd  // staged K (padded) and V rows
         + G * kChunk    // scores / probabilities
         + G * hd        // accumulator
         + 4 * G         // running max, sum, rescale, extension prob
         + kChunk        // validity of the staged rows
         + 2;            // new-token k, v scales
}

template <typename TC, bool QUANT>
__global__ void __launch_bounds__(kAttnThreads) decode_attn(AttnArgs a) {
  extern __shared__ float sm[];
  const int KV = a.KV, hd = a.hd, G = a.H / KV, half = hd / 2;
  const int bh = blockIdx.x, b = bh / KV, h = bh % KV, split = blockIdx.y;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  float* q_s = sm;
  float* ke = q_s + G * hd;
  float* ve = ke + hd;
  float* kst = ve + hd;
  float* vst = kst + hd;
  float* k_s = vst + hd;
  float* v_s = k_s + kChunk * (hd + 1);
  float* p_s = v_s + kChunk * hd;
  float* acc = p_s + G * kChunk;
  float* m_s = acc + G * hd;
  float* l_s = m_s + G;
  float* al_s = l_s + G;
  float* pe_s = al_s + G;
  float* ok_s = pe_s + G;
  float* sc_s = ok_s + kChunk;

  const int p = a.pos[b];
  const size_t qoff = (size_t)b * a.H * hd + (size_t)h * G * hd;
  for (int i = t; i < G * hd; i += kAttnThreads) {
    q_s[i] = a.q[qoff + i];
    acc[i] = 0.f;
  }
  for (int g = t; g < G; g += kAttnThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();
  const float pf = (float)p;
  if (a.use_rope) {  // rotate this head group's queries
    for (int i = t; i < G * half; i += kAttnThreads) {
      const int g = i / half, d = i % half;
      float* x = q_s + g * hd;
      const float ang = pf * expf(-(float)d * a.rope_coef);
      const float c = cosf(ang), s = sinf(ang);
      const float x1 = x[d], x2 = x[d + half];
      x[d] = x1 * c - x2 * s;
      x[d + half] = x2 * c + x1 * s;
    }
    __syncthreads();
  }

  const TC* kc = static_cast<const TC*>(a.kc);
  const TC* vc = static_cast<const TC*>(a.vc);
  const int S = a.P * a.bk;
  const int slot = a.window ? p % S : min(p, S - 1);
  const int lens = a.window ? (p > 0 ? S : 0) : min(p + 1, S);
  const int r_end = min(lens, (split + 1) * a.rows_per_split);
  for (int c0 = split * a.rows_per_split; c0 < r_end; c0 += kChunk) {
    const int nc = min(kChunk, r_end - c0);
    for (int j = t; j < nc; j += kAttnThreads) {
      const int jj = c0 + j;
      int kp;
      if (a.window) {
        const int wraps = jj <= p % S ? 0 : 1;
        kp = (p / S - wraps) * S + jj;
      } else {
        kp = jj <= p ? jj : -1;
      }
      const bool ok = kp >= 0 && jj != slot && kp <= p &&
                      (!a.window || kp > p - a.window);
      ok_s[j] = ok ? 1.f : 0.f;
    }
    for (int i = t; i < nc * hd; i += kAttnThreads) {
      const int j = i / hd, d = i % hd, jj = c0 + j;
      const size_t row = (size_t)a.table[(size_t)b * a.P + jj / a.bk] * a.bk + jj % a.bk;
      const size_t idx = (row * KV + h) * hd + d;
      float kv = cache_f32(kc[idx]), vv = cache_f32(vc[idx]);
      if constexpr (QUANT) {
        kv *= __bfloat162float(a.ks[row * KV + h]);
        vv *= __bfloat162float(a.vs[row * KV + h]);
      }
      k_s[j * (hd + 1) + d] = kv;
      v_s[j * hd + d] = vv;
    }
    __syncthreads();
    for (int i = t; i < G * nc; i += kAttnThreads) {
      const int g = i / nc, j = i % nc;
      const float* qg = q_s + g * hd;
      const float* kr = k_s + j * (hd + 1);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kr[d], s);
      p_s[g * kChunk + j] = ok_s[j] != 0.f ? s * a.scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kAttnWarps) {
      float* pg = p_s + g * kChunk;
      float mx = kNegInf;
      for (int j = lane; j < nc; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nc; j += 32) {
        const float e = ok_s[j] != 0.f ? expf(pg[j] - m_new) : 0.f;
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
    for (int o = t; o < G * hd; o += kAttnThreads) {
      const int g = o / hd, d = o % hd;
      const float* pg = p_s + g * kChunk;
      float v = acc[o] * al_s[g];
      for (int j = 0; j < nc; ++j) v = fmaf(pg[j], v_s[j * hd + d], v);
      acc[o] = v;
    }
    __syncthreads();
  }

  // publish this block's partial; the last block of (slot, head) merges
  const int stride = 2 * G + G * hd;
  float* part = a.ws + ((size_t)bh * a.splits + split) * stride;
  for (int g = t; g < G; g += kAttnThreads) {
    part[g] = m_s[g];
    part[G + g] = l_s[g];
  }
  for (int o = t; o < G * hd; o += kAttnThreads) part[2 * G + o] = acc[o];
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&a.tickets[bh], 1) == a.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the new token's K/V: RoPE, then what the cache will hold (int8 with a
  // bf16 scale, or the cache dtype) and its read-back, which the extension
  // column attends over
  const size_t kvoff = (size_t)b * KV * hd + (size_t)h * hd;
  for (int d = t; d < hd; d += kAttnThreads) {
    ke[d] = a.k[kvoff + d];
    ve[d] = a.v[kvoff + d];
  }
  __syncthreads();
  if (a.use_rope) {
    for (int d = t; d < half; d += kAttnThreads) {
      const float ang = pf * expf(-(float)d * a.rope_coef);
      const float c = cosf(ang), s = sinf(ang);
      const float x1 = ke[d], x2 = ke[d + half];
      ke[d] = x1 * c - x2 * s;
      ke[d + half] = x2 * c + x1 * s;
    }
    __syncthreads();
  }
  if (warp < 2) {
    float* e = warp == 0 ? ke : ve;
    float* st = warp == 0 ? kst : vst;
    if constexpr (QUANT) {
      float mx = 0.f;
      for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, fabsf(e[d]));
      mx = warp_max(mx);
      const float sc = mx / 127.f;
      const float den = fmaxf(sc, 1e-8f);
      const float scb = __bfloat162float(__float2bfloat16_rn(sc));
      for (int d = lane; d < hd; d += 32) {
        const float qv = rintf(e[d] / den);
        st[d] = qv;
        e[d] = qv * scb;
      }
      if (lane == 0) sc_s[warp] = sc;
    } else {
      for (int d = lane; d < hd; d += 32) {
        st[d] = round_to(e[d], static_cast<const TC*>(nullptr));
        e[d] = st[d];
      }
    }
  }
  __syncthreads();

  // merge: extension score, then the partials in row order
  const float* parts = a.ws + (size_t)bh * a.splits * stride;
  for (int g = warp; g < G; g += kAttnWarps) {
    float s = 0.f;
    for (int d = lane; d < hd; d += 32) s = fmaf(q_s[g * hd + d], ke[d], s);
    s = warp_sum(s) * a.scale;
    if (lane == 0) {
      float m = s;
      for (int sp = 0; sp < a.splits; ++sp) m = fmaxf(m, __ldcg(parts + sp * stride + g));
      float l = 0.f;
      for (int sp = 0; sp < a.splits; ++sp)
        l += __ldcg(parts + sp * stride + G + g) *
             expf(__ldcg(parts + sp * stride + g) - m);
      const float pe = expf(s - m);
      m_s[g] = m;
      pe_s[g] = pe;
      l_s[g] = l + pe;
    }
  }
  __syncthreads();
  for (int o = t; o < G * hd; o += kAttnThreads) {
    const int g = o / hd, d = o % hd;
    float v = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      v += __ldcg(parts + sp * stride + 2 * G + o) *
           expf(__ldcg(parts + sp * stride + g) - m_s[g]);
    v += pe_s[g] * ve[d];
    a.out[qoff + o] = v / fmaxf(l_s[g], 1e-20f);
  }

  // write-back: every block of (slot b, head h) has read its rows
  const size_t row = (size_t)a.table[(size_t)b * a.P + slot / a.bk] * a.bk + slot % a.bk;
  TC* kw = static_cast<TC*>(a.kc);
  TC* vw = static_cast<TC*>(a.vc);
  for (int d = t; d < hd; d += kAttnThreads) {
    put(kw + (row * KV + h) * hd + d, kst[d]);
    put(vw + (row * KV + h) * hd + d, vst[d]);
  }
  if (QUANT && t == 0) {
    a.ks[row * KV + h] = __float2bfloat16_rn(sc_s[0]);
    a.vs[row * KV + h] = __float2bfloat16_rn(sc_s[1]);
  }
  if (t == 0) a.tickets[bh] = 0;  // ready for the next launch
}

template <typename TC, bool QUANT>
int launch_attn(const AttnArgs& a, cudaStream_t st) {
  const int G = a.H / a.KV;
  const size_t bytes = sizeof(float) * (size_t)attn_smem_floats(G, a.hd);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(decode_attn<TC, QUANT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  decode_attn<TC, QUANT><<<dim3(a.B * a.KV, a.splits), kAttnThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// (a) the three gated projections of one attention layer, all slots at once:
// q = x @ wq (columns >= a_q zero), k = x @ wk and v = x @ wv (columns >=
// a_kv zero), in f32 from the weights as stored (no rounding to x's type).
extern "C" int fused_qkv_launch(const void* x, int x_dtype, const void* wq,
                                const void* wk, const void* wv, int w_dtype,
                                float* q, float* k, float* v, const int* a_q,
                                const int* a_kv, int B, int dm, int nq, int nkv,
                                int vec, int splits, int k_per_split, float* ws,
                                int* tickets, void* stream) {
  rt::GemvArgs g = {};
  g.x = x;
  g.ak = nullptr;
  g.B = B;
  g.M = 1;
  g.K = dm;
  g.nseg = 3;
  g.seg[0] = {wq, q, a_q, nq, 0};
  g.seg[1] = {wk, k, a_kv, nkv, 0};
  g.seg[2] = {wv, v, a_kv, nkv, 0};
  g.splits = splits;
  g.k_per_split = k_per_split;
  g.ws = ws;
  g.tickets = tickets;
  return rt::gemv_launch(g, x_dtype, w_dtype, rt::kF32, vec != 0, false,
                         static_cast<cudaStream_t>(stream));
}

// (b) RoPE + decode attention split over cache rows + merge + quantize round
// trip of the new K/V + cache write-back. splits * rows_per_split must cover
// the cache rows; ws holds B*KV*splits*(2G + G*hd) floats; tickets B*KV ints.
// cache_dtype: 0 f32, 1 bf16, 2 int8 (with bf16 scales).
extern "C" int fused_attn_launch(const float* q, const float* k, const float* v,
                                 void* kc, void* vc, void* ks, void* vs,
                                 int cache_dtype, const int* table,
                                 const int* pos, float* out, float* ws,
                                 int* tickets, int B, int H, int KV, int hd,
                                 int P, int bk, int window, int use_rope,
                                 int splits, int rows_per_split, float rope_coef,
                                 float scale, void* stream) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kc = kc;
  a.vc = vc;
  a.ks = static_cast<__nv_bfloat16*>(ks);
  a.vs = static_cast<__nv_bfloat16*>(vs);
  a.table = table;
  a.pos = pos;
  a.out = out;
  a.ws = ws;
  a.tickets = tickets;
  a.splits = splits;
  a.rows_per_split = rows_per_split;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.P = P;
  a.bk = bk;
  a.window = window;
  a.use_rope = use_rope;
  a.rope_coef = rope_coef;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * KV == 0) return (int)cudaGetLastError();
  if (cache_dtype == kCacheI8) return launch_attn<int8_t, true>(a, st);
  if (cache_dtype == kCacheBF16) return launch_attn<__nv_bfloat16, false>(a, st);
  return launch_attn<float, false>(a, st);
}
