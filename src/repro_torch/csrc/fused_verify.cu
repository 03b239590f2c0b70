// Fused speculative verify of one attention layer, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:_verify_kernel
// (pallas_call in _verify_pallas, called through fused_verify). Per slot it
// scores S positions (the last committed token and its drafts, or the nodes
// of a token tree) at absolute positions pos + offs[s]: the width-gated QKV
// projection in f32 from the f32 master weights, RoPE, an online softmax
// over the cache rows with kpos <= pos + offs[s] (and inside the sliding
// window), then the S extension columns of the new keys under the (S, S)
// mask ext_ok, then the width-gated output projection. The cache is read,
// never written: the new K/V go out raw (in x's dtype) as candidates for
// the commit, and with an int8 cache the extension attends through their
// quantize round trip. offs and ext_ok are operands in device memory (built
// once per topology by the wrapper), so linear and tree verify share this
// kernel.
//
// What bounds it on the H100. At TinyLlama width with B = 8 slots, S = 5 and
// a 512-row bf16 cache, one layer reads 37.7 MB of f32 weights and 4.2 MB of
// cache: 0.0125 ms at 3.35 TB/s. The f32 products are 2 * 40 rows * 2048 *
// 4608 = 0.75 GFLOP, 0.011 ms at 67 TFLOP/s on the CUDA cores: this f32
// design sits near both bounds; tensor cores are a later step. The layer is
// three launches, each reading its bytes once:
//   (a) verify_qkv_launch: the three projections as one gated skinny
//       product (gemv.cuh) over the B*S rows, row b*S + s taking slot b's
//       gates, f32 out, no weight rounding;
//   (b) verify_attn_launch (this file): blocks over (slot, KV head, range
//       of cache rows). A block holds the G*S query rows of its KV head in
//       the TPU kernel's order (g-major, then s), applies RoPE at each row's
//       own position, walks its cache rows once in 64-row chunks staged in
//       shared memory, and writes its running max, sum and accumulator as a
//       partial. The last block of a (slot, head) to finish (an atomic
//       ticket) builds the S extension keys (RoPE, raw candidates out, int8
//       round trip), merges the partials (one warp per query row, lanes
//       over the partials) and adds the extension columns under ext_ok;
//   (c) the output projection through the morph_matmul kernel over the
//       B*S rows with active_k = a_q (launched by the Python wrapper), which
//       zeroes the dead query columns' contribution.
// Traps kept from the TPU kernel: the running max starts at -1e30 and masked
// probabilities are zeroed explicitly (a fully masked chunk would otherwise
// add exp(0) = 1); the final divide is by max(l, 1e-20); dead K/V columns
// are exact zeros from the gated projection. Quantization: scale =
// absmax / 127, values rounded half to even (rintf, as jnp.round), the
// extension attending with the bf16-rounded scale.
#include <math.h>
#include <stdint.h>

#include "gemv.cuh"

namespace {

constexpr int kVThreads = 256;
constexpr int kVWarps = kVThreads / 32;
constexpr int kChunk = 64;            // cache rows staged per pass
constexpr float kNegInf = -1e30f;     // running-max init (KERNEL_NEG_INF)

enum CacheType : int { kCacheF32 = 0, kCacheBF16 = 1, kCacheI8 = 2 };

__device__ __forceinline__ float cache_f32(float v) { return v; }
__device__ __forceinline__ float cache_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float cache_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct VerifyArgs {
  const float* q;        // (B*S, H*hd) gated projections, before RoPE
  const float* k;        // (B*S, KV*hd)
  const float* v;        // (B*S, KV*hd)
  const void* kc;        // pool (n_pages, bk, KV, hd)
  const void* vc;
  const __nv_bfloat16* ks;  // (n_pages, bk, KV, 1) scales, int8 caches only
  const __nv_bfloat16* vs;
  const int* table;      // (B, P) physical page of each logical page
  const int* pos;        // (B,) committed tokens (the cache holds < pos)
  const int* offs;       // (S,) position offset of each verified row
  const int8_t* ext_ok;  // (S, S) may row s attend to new column c
  float* out;            // (B*S, H*hd) attention output, before the out proj
  void* k_new;           // (B, S, KV, hd) raw candidates, x's dtype
  void* v_new;
  float* ws;             // (B*KV, splits, 2*G*S + G*S*hd) partials
  int* tickets;          // (B*KV,) zeroed; left zeroed
  int x_dtype;           // 0 f32, 1 bf16 (the candidates' type)
  int B, H, KV, hd, S, P, bk, window, use_rope;
  int splits, rows_per_split;  // rows_per_split: a multiple of kChunk
  float rope_coef;       // log(theta) / (hd / 2)
  float scale;           // 1 / sqrt(hd)
};

// Shared-memory bytes of one block (the launch is sized by it).
__host__ __device__ inline int verify_smem_bytes(int G, int S, int hd) {
  const int GS = G * S;
  return 4 * (2 * GS * hd                     // queries, accumulator
              + kChunk * (hd + 1) + kChunk * hd  // staged K (padded) and V
              + GS * kChunk                   // scores / probabilities
              + 3 * GS                        // running max, sum, rescale
              + kChunk + S);                  // ints: row positions, offsets
}

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
}

__device__ __forceinline__ void rotate(float* x, int half, int d, float pf,
                                       float coef) {
  const float ang = pf * expf(-(float)d * coef);
  const float c = cosf(ang), s = sinf(ang);
  const float x1 = x[d], x2 = x[d + half];
  x[d] = x1 * c - x2 * s;
  x[d + half] = x2 * c + x1 * s;
}

template <typename TC, bool QUANT>
__global__ void __launch_bounds__(kVThreads) verify_attn(VerifyArgs a) {
  extern __shared__ float sm[];
  const int KV = a.KV, hd = a.hd, S = a.S, G = a.H / KV, GS = G * S;
  const int half = hd / 2, qd = a.H * hd, kvd = KV * hd;
  const int bh = blockIdx.x, b = bh / KV, h = bh % KV, split = blockIdx.y;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  float* q_s = sm;
  float* acc = q_s + GS * hd;
  float* k_s = acc + GS * hd;
  float* v_s = k_s + kChunk * (hd + 1);
  float* p_s = v_s + kChunk * hd;
  float* m_s = p_s + GS * kChunk;
  float* l_s = m_s + GS;
  float* al_s = l_s + GS;
  int* kp_s = reinterpret_cast<int*>(al_s + GS);
  int* of_s = kp_s + kChunk;

  const int p = a.pos[b];
  for (int i = t; i < S; i += kVThreads) of_s[i] = a.offs[i];
  // row r = g*S + s: head h*G + g of verified position s
  for (int i = t; i < GS * hd; i += kVThreads) {
    const int r = i / hd, d = i % hd, g = r / S, s = r % S;
    q_s[i] = a.q[(size_t)(b * S + s) * qd + (size_t)(h * G + g) * hd + d];
    acc[i] = 0.f;
  }
  for (int r = t; r < GS; r += kVThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (a.use_rope) {
    for (int i = t; i < GS * half; i += kVThreads) {
      const int r = i / half;
      rotate(q_s + r * hd, half, i % half, (float)(p + of_s[r % S]), a.rope_coef);
    }
    __syncthreads();
  }

  const TC* kc = static_cast<const TC*>(a.kc);
  const TC* vc = static_cast<const TC*>(a.vc);
  const int Sc = a.P * a.bk;
  const int lens = a.window ? (p > 0 ? Sc : 0) : min(p, Sc);
  const int last = p - 1;  // newest committed position; >= 0 when lens > 0
  const int r_end = min(lens, (split + 1) * a.rows_per_split);
  for (int c0 = split * a.rows_per_split; c0 < r_end; c0 += kChunk) {
    const int nc = min(kChunk, r_end - c0);
    for (int j = t; j < nc; j += kVThreads) {
      const int jj = c0 + j;
      int kp;
      if (a.window) {
        const int wraps = jj <= last % Sc ? 0 : 1;
        kp = (last / Sc - wraps) * Sc + jj;
      } else {
        kp = jj < p ? jj : -1;
      }
      kp_s[j] = kp;
    }
    for (int i = t; i < nc * hd; i += kVThreads) {
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
    for (int i = t; i < GS * nc; i += kVThreads) {
      const int r = i / nc, j = i % nc;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + j * (hd + 1);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      const bool ok = visible(kp_s[j], p + of_s[r % S], a.window);
      p_s[r * kChunk + j] = ok ? s * a.scale : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < GS; r += kVWarps) {
      float* pr = p_s + r * kChunk;
      const int qp = p + of_s[r % S];
      float mx = kNegInf;
      for (int j = lane; j < nc; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nc; j += 32) {
        const float e = visible(kp_s[j], qp, a.window) ? expf(pr[j] - m_new) : 0.f;
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int o = t; o < GS * hd; o += kVThreads) {
      const int r = o / hd, d = o % hd;
      const float* pr = p_s + r * kChunk;
      float v = acc[o] * al_s[r];
      for (int j = 0; j < nc; ++j) v = fmaf(pr[j], v_s[j * hd + d], v);
      acc[o] = v;
    }
    __syncthreads();
  }

  // publish this block's partial; the last block of (slot, head) merges
  const int stride = 2 * GS + GS * hd;
  float* part = a.ws + ((size_t)bh * a.splits + split) * stride;
  for (int r = t; r < GS; r += kVThreads) {
    part[r] = m_s[r];
    part[GS + r] = l_s[r];
  }
  for (int o = t; o < GS * hd; o += kVThreads) part[2 * GS + o] = acc[o];
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&a.tickets[bh], 1) == a.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the S new keys/values of head h (the staging buffers are free now):
  // RoPE, the raw candidates out, then what the extension attends over
  float* ke = k_s;  // (S, hd)
  float* ve = v_s;  // (S, hd)
  for (int i = t; i < S * hd; i += kVThreads) {
    const int s = i / hd, d = i % hd;
    const size_t src = (size_t)(b * S + s) * kvd + (size_t)h * hd + d;
    ke[i] = a.k[src];
    ve[i] = a.v[src];
  }
  __syncthreads();
  if (a.use_rope) {
    for (int i = t; i < S * half; i += kVThreads) {
      const int s = i / half;
      rotate(ke + s * hd, half, i % half, (float)(p + of_s[s]), a.rope_coef);
    }
    __syncthreads();
  }
  for (int i = t; i < S * hd; i += kVThreads) {
    const int s = i / hd, d = i % hd;
    const size_t dst = ((size_t)(b * S + s) * KV + h) * hd + d;
    if (a.x_dtype == rt::kF32) {
      static_cast<float*>(a.k_new)[dst] = ke[i];
      static_cast<float*>(a.v_new)[dst] = ve[i];
    } else {
      static_cast<__nv_bfloat16*>(a.k_new)[dst] = __float2bfloat16_rn(ke[i]);
      static_cast<__nv_bfloat16*>(a.v_new)[dst] = __float2bfloat16_rn(ve[i]);
    }
  }
  if constexpr (QUANT) {
    __syncthreads();  // candidates stored before the round trip rewrites them
    for (int w = warp; w < 2 * S; w += kVWarps) {
      float* e = (w < S ? ke : ve) + (w % S) * hd;
      float mx = 0.f;
      for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, fabsf(e[d]));
      mx = warp_max(mx);
      const float sc = mx / 127.f;
      const float den = fmaxf(sc, 1e-8f);
      const float scb = __bfloat162float(__float2bfloat16_rn(sc));
      for (int d = lane; d < hd; d += 32) e[d] = rintf(e[d] / den) * scb;
    }
  }
  __syncthreads();

  // merge, one warp per query row, lanes over the partials: the row's max
  // over the partials and the extension scores, each partial's rescale
  // exp(m_sp - m) (kept in the accumulator buffer, free now: splits <= hd),
  // and the softmax sum
  const float* parts = a.ws + (size_t)bh * a.splits * stride;
  float* se = p_s;   // (GS, S) extension scores, then probabilities
  float* wsp = acc;  // (splits, GS) partial rescales
  for (int r = warp; r < GS; r += kVWarps) {
    const int s = r % S;
    for (int c = 0; c < S; ++c) {
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot = fmaf(q_s[r * hd + d], ke[c * hd + d], dot);
      dot = warp_sum(dot) * a.scale;
      if (lane == 0) se[r * S + c] = a.ext_ok[s * S + c] ? dot : kNegInf;
    }
    __syncwarp();
    float m = kNegInf;
    for (int sp = lane; sp < a.splits; sp += 32) m = fmaxf(m, __ldcg(parts + sp * stride + r));
    for (int c = lane; c < S; c += 32) m = fmaxf(m, se[r * S + c]);
    m = warp_max(m);
    __syncwarp();
    float l = 0.f;
    for (int sp = lane; sp < a.splits; sp += 32) {
      const float w = expf(__ldcg(parts + sp * stride + r) - m);
      wsp[sp * GS + r] = w;
      l = fmaf(__ldcg(parts + sp * stride + GS + r), w, l);
    }
    for (int c = lane; c < S; c += 32) {
      const float pe = a.ext_ok[s * S + c] ? expf(se[r * S + c] - m) : 0.f;
      se[r * S + c] = pe;
      l += pe;
    }
    l = warp_sum(l);
    if (lane == 0) l_s[r] = l;
  }
  __syncthreads();
  for (int o = t; o < GS * hd; o += kVThreads) {
    const int r = o / hd, d = o % hd, g = r / S, s = r % S;
    float v = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < a.splits; ++sp)
      v = fmaf(__ldcg(parts + sp * stride + 2 * GS + o), wsp[sp * GS + r], v);
    for (int c = 0; c < S; ++c) v = fmaf(se[r * S + c], ve[c * hd + d], v);
    a.out[(size_t)(b * S + s) * qd + (size_t)(h * G + g) * hd + d] =
        v / fmaxf(l_s[r], 1e-20f);
  }
  if (t == 0) a.tickets[bh] = 0;  // ready for the next launch
}

template <typename TC, bool QUANT>
int launch_verify(const VerifyArgs& a, cudaStream_t st) {
  const int bytes = verify_smem_bytes(a.H / a.KV, a.S, a.hd);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        verify_attn<TC, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  verify_attn<TC, QUANT><<<dim3(a.B * a.KV, a.splits), kVThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// (a) the three gated projections of one attention layer over B*M rows
// (M = S verified positions per slot; row b*M + s takes slot b's gates):
// q = x @ wq (columns >= a_q zero), k = x @ wk and v = x @ wv (columns >=
// a_kv zero), in f32 from the weights as stored.
extern "C" int verify_qkv_launch(const void* x, int x_dtype, const void* wq,
                                 const void* wk, const void* wv, int w_dtype,
                                 float* q, float* k, float* v, const int* a_q,
                                 const int* a_kv, int B, int M, int dm, int nq,
                                 int nkv, int splits, int k_per_split,
                                 void* stream) {
  rt::GemvArgs g = {};
  g.x = x;
  g.ak = nullptr;
  g.B = B;
  g.M = M;
  g.K = dm;
  g.nseg = 3;
  g.seg[0] = {wq, q, a_q, nq, 0};
  g.seg[1] = {wk, k, a_kv, nkv, 0};
  g.seg[2] = {wv, v, a_kv, nkv, 0};
  g.splits = splits;
  g.k_per_split = k_per_split;
  return rt::gemv_launch<false>(g, x_dtype, w_dtype, rt::kF32, false,
                                static_cast<cudaStream_t>(stream));
}

// (b) RoPE + attention over the cache split into row ranges + merge with
// the S extension columns under ext_ok + raw candidates out. splits *
// rows_per_split must cover the cache rows, splits <= hd; ws holds
// B*KV*splits*(2*G*S + G*S*hd) floats, tickets B*KV ints; S <= 64. cache_dtype: 0 f32, 1 bf16,
// 2 int8 (with bf16 scales); x_dtype: 0 f32, 1 bf16.
extern "C" int verify_attn_launch(const float* q, const float* k, const float* v,
                                  const void* kc, const void* vc, const void* ks,
                                  const void* vs, int cache_dtype,
                                  const int* table, const int* pos,
                                  const int* offs, const int8_t* ext_ok,
                                  float* out, void* k_new, void* v_new,
                                  float* ws, int* tickets, int x_dtype, int B,
                                  int H, int KV, int hd, int S, int P, int bk,
                                  int window, int use_rope, int splits,
                                  int rows_per_split, float rope_coef,
                                  float scale, void* stream) {
  VerifyArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kc = kc;
  a.vc = vc;
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.table = table;
  a.pos = pos;
  a.offs = offs;
  a.ext_ok = ext_ok;
  a.out = out;
  a.k_new = k_new;
  a.v_new = v_new;
  a.ws = ws;
  a.tickets = tickets;
  a.x_dtype = x_dtype;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.S = S;
  a.P = P;
  a.bk = bk;
  a.window = window;
  a.use_rope = use_rope;
  a.splits = splits;
  a.rows_per_split = rows_per_split;
  a.rope_coef = rope_coef;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * KV == 0 || S == 0) return (int)cudaGetLastError();
  if (cache_dtype == kCacheI8) return launch_verify<int8_t, true>(a, st);
  if (cache_dtype == kCacheBF16) return launch_verify<__nv_bfloat16, false>(a, st);
  return launch_verify<float, false>(a, st);
}
