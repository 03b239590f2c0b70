// Fused one-token decode of one attention layer, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:_decode_kernel
// (pallas_call in _decode_pallas, called through fused_decode_step). Per slot
// it computes the width-gated QKV projection in f32 from the f32 master
// weights, RoPE, the optional int8 absmax round trip of the new K/V, an
// online-softmax decode over the slot's cache rows (a dense cache, or a
// page pool read through the slot's page table, the TPU kernel's tbl_ref),
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
//   (b) fused_attn_launch (this file): the shared decode-attention core
//       (decode_attn.cuh: its bound and design) with one unit per (slot, KV
//       head), its cache rows split over one thread block cluster. Every
//       block applies RoPE to its heads' queries and works out the new
//       token's K/V (RoPE, the quantize round trip) while its first chunks
//       load; the cluster merges the partials through distributed shared
//       memory with the extension column; after the cluster's first barrier
//       (every block has read its rows) the block whose rows hold the
//       slot's position writes the new K/V and scales into the cache
//       (paged: at the physical row the slot's table maps that position to,
//       da::PageTable);
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

#include "decode_attn.cuh"
#include "gemv.cuh"

namespace {

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const int8_t*) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(int8_t* p, float v) { *p = (int8_t)v; }

// The extension's floats in the core's `ext` buffer: the attended new k and
// v, their stored values, the extension score of each head, the k/v scales,
// and RoPE's cosines and sines.
constexpr int kExtKe = 0, kExtVe = da::kMaxHD, kExtKst = 2 * da::kMaxHD,
              kExtVst = 3 * da::kMaxHD, kExtS = 4 * da::kMaxHD,
              kExtSc = kExtS + da::kMaxHeads, kExtRope = kExtSc + 2;

template <typename TC, bool QUANT>
struct FusedAttnProb {
  // the core's interface (decode_attn.cuh)
  int units, hgroups, G, hd, rps, vec;
  float scale;
  const void* kc;       // (B, S, KV, hd), or a page pool (n_pages, ps, KV, hd)
  const void* vc;
  static constexpr bool kQuant = QUANT;
  static constexpr bool kExt = true;
  static constexpr bool kRowMask = false;
  static constexpr int kMTiles = 1;
  static constexpr int kExtFloats = kExtRope + da::kMaxHD;
  int ext_floats() const { return kExtFloats; }
  // this problem
  const float* q;       // (B, H*hd) gated projections, before RoPE
  const float* k;       // (B, KV*hd)
  const float* v;       // (B, KV*hd)
  __nv_bfloat16* ks;    // (B, S, KV, 1) scales (or pooled), int8 caches only
  __nv_bfloat16* vs;
  const int* pos;       // (B,) absolute position of the new token
  float* out;           // (B, H*hd) attention output, before the out proj
  da::PageTable pt;     // the slot's pages; pt.table null: a dense cache
  int H, KV, S, window, use_rope;  // S: positions a slot sees (paged: P * ps)
  float rope_coef;      // log(theta) / (hd / 2)
  int b, h, h0, nh, p, slot, p_div, p_mod;  // this block

  __device__ int begin(int unit, int h0_, int nh_) {
    b = unit / KV;
    h = unit % KV;
    h0 = h0_;
    nh = nh_;
    p = pos[b];
    if (pt.table) pt.load(b, (int)blockIdx.y * rps, rps, (int)threadIdx.x);
    p_div = p / S;
    p_mod = p % S;
    slot = window ? p_mod : min(p, S - 1);
    return window ? (p > 0 ? S : 0) : min(p + 1, S);
  }
  __device__ bool ok(int jj) const {
    int kp;
    if (window) {
      const int wraps = jj <= p_mod ? 0 : 1;
      kp = (p_div - wraps) * S + jj;
    } else {
      kp = jj <= p ? jj : -1;
    }
    return kp >= 0 && jj != slot && kp <= p && (!window || kp > p - window);
  }
  __device__ size_t phys(int jj) const {
    return pt.table ? pt.phys(jj) : (size_t)b * S + jj;
  }
  __device__ size_t row(int jj) const { return (phys(jj) * KV + h) * hd; }
  __device__ float kscale(int jj) const {
    return __bfloat162float(ks[phys(jj) * KV + h]);
  }
  __device__ float vscale(int jj) const {
    return __bfloat162float(vs[phys(jj) * KV + h]);
  }
  template <int HDP, int MR>
  __device__ void load_q(float* qs, int ldq, float* ext, int t) const {
    constexpr int N = MR * HDP / da::kThreads;
    const size_t qoff = (size_t)b * H * hd + ((size_t)h * G + h0) * hd;
    const size_t kvoff = (size_t)b * KV * hd + (size_t)h * hd;
    float x[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = t + u * da::kThreads, r = i / HDP, d = i % HDP;
      x[u] = r < nh && d < hd ? q[qoff + (size_t)r * hd + d] : 0.f;
    }
    // hd <= kMaxHD = kThreads: one element of the new k and v per thread
    const float kx = t < hd ? k[kvoff + t] : 0.f;
    const float vx = t < hd ? v[kvoff + t] : 0.f;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = t + u * da::kThreads;
      qs[(i / HDP) * ldq + i % HDP] = x[u];
    }
    if (t < hd) {
      ext[kExtKe + t] = kx;
      ext[kExtVe + t] = vx;
    }
  }
  // RoPE of the queries and the new key; the new K/V as the cache will
  // hold them (int8 with a bf16 scale, or the cache dtype) and their
  // read-back, which the extension attends over; the extension's scores
  template <int HDP, int MR>
  __device__ void prepare(float* qs, int ldq, float* ext, int t) const {
    const int half = hd / 2, warp = t / 32, lane = t % 32;
    float* ke = ext + kExtKe;
    float* ve = ext + kExtVe;
    const float pf = (float)p;
    if (use_rope) {  // the angles once per column pair, then every row
      float* cs = ext + kExtRope;
      for (int d = t; d < half; d += da::kThreads) {
        const float ang = pf * expf(-(float)d * rope_coef);
        cs[d] = cosf(ang);
        cs[half + d] = sinf(ang);
      }
      __syncthreads();
      for (int i = t; i < (nh + 1) * half; i += da::kThreads) {
        const int r = i / half, d = i % half;
        float* x = r < nh ? qs + r * ldq : ke;
        const float c = cs[d], s = cs[half + d];
        const float x1 = x[d], x2 = x[d + half];
        x[d] = x1 * c - x2 * s;
        x[d + half] = x2 * c + x1 * s;
      }
      __syncthreads();
    }
    if (warp < 2) {
      float* e = warp == 0 ? ke : ve;
      float* st = ext + (warp == 0 ? kExtKst : kExtVst);
      if constexpr (QUANT) {
        float mx = 0.f;
        for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, fabsf(e[d]));
        mx = da::warp_max(mx);
        const float sc = mx / 127.f;
        const float den = fmaxf(sc, 1e-8f);
        const float scb = __bfloat162float(__float2bfloat16_rn(sc));
        for (int d = lane; d < hd; d += 32) {
          const float qv = rintf(e[d] / den);
          st[d] = qv;
          e[d] = qv * scb;
        }
        if (lane == 0) ext[kExtSc + warp] = sc;
      } else {
        for (int d = lane; d < hd; d += 32) {
          st[d] = round_to(e[d], static_cast<const TC*>(nullptr));
          e[d] = st[d];
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < nh; r += da::kWarps) {
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s = fmaf(qs[r * ldq + d], ke[d], s);
      s = da::warp_sum(s) * scale;
      if (lane == 0) ext[kExtS + r] = s;
    }
  }
  // one extension column: the new token
  __device__ int ext_cols() const { return 1; }
  __device__ bool ext_ok(const float*, int, int) const { return true; }
  __device__ float ext_score(const float* ext, int r, int) const {
    return ext[kExtS + r];
  }
  __device__ float ext_value(const float* ext, int, int d) const {
    return ext[kExtVe + d];
  }
  __device__ void store(int r, int d, float val) const {
    out[(size_t)b * H * hd + ((size_t)h * G + h0 + r) * hd + d] = val;
  }
  // write-back: every block of (slot b, head h) has read its rows. The
  // block whose split range holds the slot's row writes it: paged, that
  // block holds the row's table entry in shared memory (any other block
  // would wait on a table read at its end). A free slot's table row points
  // at its scratch page, so a whole-batch launch writes a free slot's
  // garbage there.
  __device__ void after_merge(float* ext, int split, int hg, int t) const {
    if (split != slot / rps || hg != 0) return;
    const size_t row = phys(slot);
    TC* kw = static_cast<TC*>(const_cast<void*>(kc));
    TC* vw = static_cast<TC*>(const_cast<void*>(vc));
    for (int d = t; d < hd; d += da::kThreads) {
      put(kw + (row * KV + h) * hd + d, ext[kExtKst + d]);
      put(vw + (row * KV + h) * hd + d, ext[kExtVst + d]);
    }
    if (QUANT && t == 0) {
      ks[row * KV + h] = __float2bfloat16_rn(ext[kExtSc]);
      vs[row * KV + h] = __float2bfloat16_rn(ext[kExtSc + 1]);
    }
  }
};

template <typename TC, bool QUANT>
int launch_attn(const float* q, const float* k, const float* v, void* kc,
                void* vc, void* ks, void* vs, const int* pos, float* out,
                int B, int H, int KV, int hd, int S, const int* table, int ps,
                int P, int window, int use_rope, int splits,
                int rows_per_split, float rope_coef, float scale,
                cudaStream_t st, int* max_clusters, int* route) {
  FusedAttnProb<TC, QUANT> a = {};
  a.units = B * KV;
  a.G = KV > 0 ? H / KV : 1;
  a.hgroups = (a.G + da::kMaxHeads - 1) / da::kMaxHeads;
  a.hd = hd;
  a.rps = rows_per_split;
  a.vec = (hd * (int)sizeof(TC)) % 16 == 0 && da::aligned16(kc) &&
          da::aligned16(vc);
  a.scale = scale;
  a.kc = kc;
  a.vc = vc;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<__nv_bfloat16*>(ks);
  a.vs = static_cast<__nv_bfloat16*>(vs);
  a.pos = pos;
  a.out = out;
  a.pt.table = table;
  a.pt.ps = ps;
  a.pt.P = P;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.window = window;
  a.use_rope = use_rope;
  a.rope_coef = rope_coef;
  // bf16 and int8 caches on the tensor cores (q is f32: split hi + lo)
  return da::launch_hd<decltype(a), TC, true>(a, splits, st, max_clusters,
                                              route);
}

int dispatch_attn(const float* q, const float* k, const float* v, void* kc,
                  void* vc, void* ks, void* vs, int cache_dtype,
                  const int* pos, float* out, int B, int H, int KV, int hd,
                  int S, const int* table, int ps, int P, int window,
                  int use_rope, int splits, int rows_per_split,
                  float rope_coef, float scale, cudaStream_t st,
                  int* max_clusters, int* route) {
  if (cache_dtype == da::kI8)
    return launch_attn<int8_t, true>(q, k, v, kc, vc, ks, vs, pos, out, B, H,
                                     KV, hd, S, table, ps, P, window,
                                     use_rope, splits, rows_per_split,
                                     rope_coef, scale, st, max_clusters,
                                     route);
  if (cache_dtype == da::kBF16)
    return launch_attn<__nv_bfloat16, false>(
        q, k, v, kc, vc, ks, vs, pos, out, B, H, KV, hd, S, table, ps, P,
        window, use_rope, splits, rows_per_split, rope_coef, scale, st,
        max_clusters, route);
  return launch_attn<float, false>(q, k, v, kc, vc, ks, vs, pos, out, B, H,
                                   KV, hd, S, table, ps, P, window, use_rope,
                                   splits, rows_per_split, rope_coef, scale,
                                   st, max_clusters, route);
}

}  // namespace

// (a) the three gated projections of one attention layer, all slots at once:
// q = x @ wq (columns >= a_q zero), k = x @ wk and v = x @ wv (columns >=
// a_kv zero), in f32 from the weights as stored (no rounding to x's type).
extern "C" int fused_qkv_launch(const void* x, int x_dtype, const void* wq,
                                const void* wk, const void* wv, int w_dtype,
                                float* q, float* k, float* v, const int* a_q,
                                const int* a_kv, int B, int dm, int nq, int nkv,
                                int splits, int k_per_split,
                                void* stream) {
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
  return rt::gemv_launch<false>(g, x_dtype, w_dtype, rt::kF32, false,
                                static_cast<cudaStream_t>(stream));
}

// (b) RoPE + decode attention split over cache rows + merge + quantize round
// trip of the new K/V + cache write-back, over a dense (B, S, KV, hd) cache
// (table null), or over a page pool (n_pages, ps, KV, hd) through the (B,
// P) int32 page table `table`, S = P * ps. The splits of a (slot, head) form
// one cluster (1 <= splits <= 16); splits * rows_per_split must cover the S
// cache rows, rows_per_split a multiple of 64. cache_dtype: 0 f32, 1 bf16,
// 2 int8 (with bf16 scales). Writes the route of the kernel launched (0 f32
// FMAs, 1 tensor cores) to *route.
extern "C" int fused_attn_launch(const float* q, const float* k, const float* v,
                                 void* kc, void* vc, void* ks, void* vs,
                                 int cache_dtype, const int* pos, float* out,
                                 int B, int H, int KV, int hd, int S,
                                 const int* table, int ps, int P, int window,
                                 int use_rope, int splits, int rows_per_split,
                                 float rope_coef, float scale, int* route,
                                 void* stream) {
  if (KV < 1 || H % KV != 0 || hd < 1 || hd > da::kMaxHD || hd % 2 != 0 ||
      (long long)splits * rows_per_split < S ||
      (table && (ps < 1 || P < 1 || (long long)P * ps != S)))
    return (int)cudaErrorInvalidValue;
  return dispatch_attn(q, k, v, kc, vc, ks, vs, cache_dtype, pos, out, B, H,
                       KV, hd, S, table, ps, P, window, use_rope, splits,
                       rows_per_split, rope_coef, scale,
                       static_cast<cudaStream_t>(stream), nullptr, route);
}

// How many clusters of `splits` blocks of the attention kernel for this
// cache dtype and hd fit on the card at once; written to *out.
extern "C" int fused_attn_max_clusters(int cache_dtype, int hd, int splits,
                                       int* out) {
  if (hd < 1 || hd > da::kMaxHD) return (int)cudaErrorInvalidValue;
  return dispatch_attn(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, cache_dtype, nullptr, nullptr, 1, 1, 1, hd, 1,
                       nullptr, 1, 1, 0, 0, splits, da::kChunk, 1.f, 1.f,
                       nullptr, out, nullptr);
}
