// Fused speculative verify of one attention layer, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:_verify_kernel
// (pallas_call in _verify_pallas, called through fused_verify). Per slot it
// scores S positions (the last committed token and its drafts, or the nodes
// of a token tree) at absolute positions pos + offs[s] over its cache rows
// (a dense cache, or a page pool read through the slot's page table, the
// TPU kernel's tbl_ref; da::PageTable): the width-gated QKV projection in
// f32 from the f32 master weights, RoPE, an online softmax
// over the cache rows with kpos <= pos + offs[s] (and inside the sliding
// window), then the S extension columns of the new keys under the (S, S)
// mask ext_ok, then the width-gated output projection. The cache is read,
// never written: the new K/V go out raw (in x's dtype) as candidates for
// the commit, and with an int8 cache the extension attends through their
// quantize round trip. offs and ext_ok are operands in device memory (built
// once per topology by the wrapper), so linear and tree verify share this
// kernel.
//
// What bounds it on the H100: bytes. At TinyLlama width with B = 8 slots,
// S = 5 and a 512-row bf16 cache, one layer reads 37.7 MB of f32 weights
// and up to 4.2 MB of cache: 0.0125 ms at 3.35 TB/s; the f32 projections
// are 0.75 GFLOP, 0.011 ms at 67 TFLOP/s. The layer is three launches, each
// reading its bytes once:
//   (a) verify_qkv_launch: the three projections as one gated skinny
//       product (gemv.cuh) over the B*S rows, row b*S + s taking slot b's
//       gates, f32 out, no weight rounding;
//   (b) verify_attn_launch (this file): the shared decode-attention core
//       (decode_attn.cuh: its design) with one unit per (slot, KV head)
//       whose G*S query rows, in the TPU kernel's order (g-major, then s),
//       are the MMA's M side: 40 rows at G = 8, S = 5 (three m16 tiles),
//       56 for the (2, 2) tree (four). A block carries all of them (up to
//       kMTiles = 4 tiles, 2 at hd 128), so a K/V chunk is read from device
//       memory once per (slot, KV head); spreading the rows over 16-row
//       groups instead would read it once per group, 3-4 times the cache
//       bytes and clusters, for 96 fewer accumulator registers. The cost is
//       registers (~128 of accumulators) and shared memory (the warps'
//       partials of 64 rows), two blocks per SM; the launch still takes
//       every cluster in one wave (the plan reads the kernel's own
//       occupancy, kernels/decode_attn.py). Every block applies RoPE to its
//       rows at each row's own position, builds the S extension keys (RoPE,
//       the int8 round trip) and their f32 scores while its first chunks
//       load; the cluster merges the splits through distributed shared
//       memory, then the S extension columns under ext_ok in f32 FMAs. The
//       first block of a unit writes the raw candidates. Under a sliding
//       window the lower edge of the visible cache rows moves with each
//       row's position: that problem masks per (row, cache row).
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

#include "decode_attn.cuh"
#include "gemv.cuh"

namespace {

enum XType : int { kXF32 = 0, kXBF16 = 1 };

// The verify problem on the decode-attention core. Query row r of a unit
// (slot b, KV head h) is head h * Gq + r / S at verified position r % S.
template <typename TC, bool QUANT, bool WINDOW>
struct VerifyProb {
  // the core's interface (decode_attn.cuh)
  int units, hgroups, G, hd, rps, vec;  // G: query rows per unit, Gq * S
  float scale;
  const void* kc;       // (B, Sc, KV, hd), or a page pool (n_pages, ps, KV, hd)
  const void* vc;
  static constexpr bool kQuant = QUANT;
  static constexpr bool kExt = true;
  static constexpr bool kRowMask = WINDOW;
  static constexpr int kMTiles = 4;
  // this problem
  const float* q;       // (B*S, H*hd) gated projections, before RoPE
  const float* k;       // (B*S, KV*hd)
  const float* v;       // (B*S, KV*hd)
  const __nv_bfloat16* ks;  // (B, Sc, KV, 1) scales, int8 caches only
  const __nv_bfloat16* vs;
  const int* pos;       // (B,) committed tokens (the cache holds < pos)
  const int* offs;      // (S,) position offset of each verified row
  const int8_t* ext_ok_g;  // (S, S) may row s attend to new column c
  float* out;           // (B*S, H*hd) attention output, before the out proj
  void* k_new;          // (B, S, KV, hd) raw candidates, x's dtype
  void* v_new;
  da::PageTable pt;     // the slot's pages; pt.table null: a dense cache
  // rows: <= MR; Sc: cache positions a slot sees (paged: P * ps)
  int x_dtype, H, KV, Gq, S, Sc, window, use_rope, rows;
  float rope_coef;      // log(theta) / (hd / 2)
  int b, h, h0, nh, p, last_div, last_mod;  // this block

  // the extension's floats: the S new keys and values (what the extension
  // attends), RoPE's cosines and sines per position, the scores of the
  // block's rows, the (S, S) mask, the offsets
  __host__ __device__ int e_v() const { return S * hd; }
  __host__ __device__ int e_cs() const { return 2 * S * hd; }
  __host__ __device__ int e_sc() const { return 3 * S * hd; }
  __host__ __device__ int e_ok() const { return e_sc() + rows * S; }
  __host__ __device__ int e_off() const { return e_ok() + S * S; }
  int ext_floats() const { return e_off() + S; }

  __device__ int begin(int unit, int h0_, int nh_) {
    b = unit / KV;
    h = unit % KV;
    h0 = h0_;
    nh = nh_;
    p = pos[b];
    if (pt.table) pt.load(b, (int)blockIdx.y * rps, rps, (int)threadIdx.x);
    if (WINDOW) {
      const int last = max(p - 1, 0);  // newest committed position
      last_div = last / Sc;
      last_mod = last % Sc;
      return p > 0 ? Sc : 0;
    }
    return min(p, Sc);
  }
  // absolute position of cache row jj (rows < n)
  __device__ int kpos(int jj) const {
    if (!WINDOW) return jj;
    return (last_div - (jj <= last_mod ? 0 : 1)) * Sc + jj;
  }
  // without a window every row < n = min(pos, Sc) is below every query
  // row's position; with one, kpos <= pos - 1 still, and rows never
  // written are negative
  __device__ bool ok(int jj) const { return !WINDOW || kpos(jj) >= 0; }
  __device__ int row_key(const float* ext, int r) const {
    const int s = (h0 + r) % S;
    return p + reinterpret_cast<const int*>(ext + e_off())[s] - window;
  }
  __device__ bool ok_row(int key, int jj) const { return kpos(jj) > key; }
  __device__ size_t phys(int jj) const {
    return pt.table ? pt.phys(jj) : (size_t)b * Sc + jj;
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
    constexpr int NKV = 4;  // new k / v values per thread in the first batch
    const int qd = H * hd, kvd = KV * hd;
    // q as float4: this thread's 4-column groups step by RS rows, their
    // (g, s) by steps (no division per element); rows 16-byte aligned when
    // hd % 4 == 0, else one element at a time
    constexpr int N4 = (MR * HDP / 4 + da::kThreads - 1) / da::kThreads;
    constexpr int RS = 4 * da::kThreads / HDP;
    const bool v4 = hd % 4 == 0;
    float4 x[N4];
    float kx[NKV], vx[NKV];
    const int d = (4 * t) % HDP;
    int gq = (h0 + 4 * t / HDP) / S, sq = (h0 + 4 * t / HDP) % S;
#pragma unroll
    for (int u = 0; u < N4; ++u) {
      const int r = 4 * t / HDP + u * RS;
      const float* src = q + (size_t)(b * S + sq) * qd + (size_t)(h * Gq + gq) * hd + d;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nh) {
        if (v4 && d < hd) {
          x[u] = *reinterpret_cast<const float4*>(src);
        } else if (!v4) {
          x[u].x = d < hd ? src[0] : 0.f;
          x[u].y = d + 1 < hd ? src[1] : 0.f;
          x[u].z = d + 2 < hd ? src[2] : 0.f;
          x[u].w = d + 3 < hd ? src[3] : 0.f;
        }
      }
      sq += RS;
      while (sq >= S) {
        sq -= S;
        ++gq;
      }
    }
#pragma unroll
    for (int u = 0; u < NKV; ++u) {
      const int i = t + u * da::kThreads;
      const size_t src = (size_t)(b * S + i / hd) * kvd + (size_t)h * hd + i % hd;
      kx[u] = i < S * hd ? k[src] : 0.f;
      vx[u] = i < S * hd ? v[src] : 0.f;
    }
    const int of = t < S ? offs[t] : 0;
    const int8_t okv = t < S * S ? ext_ok_g[t] : 0;
#pragma unroll
    for (int u = 0; u < N4; ++u) {
      const int i = 4 * (t + u * da::kThreads);
      if (i < MR * HDP)
        *reinterpret_cast<float4*>(qs + (i / HDP) * ldq + i % HDP) = x[u];
    }
#pragma unroll
    for (int u = 0; u < NKV; ++u) {
      const int i = t + u * da::kThreads;
      if (i < S * hd) {
        ext[i] = kx[u];
        ext[e_v() + i] = vx[u];
      }
    }
    for (int i = t + NKV * da::kThreads; i < S * hd; i += da::kThreads) {
      const size_t src = (size_t)(b * S + i / hd) * kvd + (size_t)h * hd + i % hd;
      ext[i] = k[src];
      ext[e_v() + i] = v[src];
    }
    if (t < S) reinterpret_cast<int*>(ext + e_off())[t] = of;
    if (t < S * S) ext[e_ok() + t] = okv ? 1.f : 0.f;
    for (int i = t + da::kThreads; i < S * S; i += da::kThreads)
      ext[e_ok() + i] = ext_ok_g[i] ? 1.f : 0.f;
  }
  // RoPE of the rows and of the new keys at each one's own position; the
  // raw candidates out (one block per unit); the int8 round trip of what
  // the extension attends; the extension's scores of the block's rows
  template <int HDP, int MR>
  __device__ void prepare(float* qs, int ldq, float* ext, int t) const {
    const int half = hd / 2, warp = t / 32, lane = t % 32;
    float* ke = ext;
    float* ve = ext + e_v();
    const int* of = reinterpret_cast<const int*>(ext + e_off());
    if (use_rope) {
      // a thread per column pair d (of HDP / 2) and every RS-th row
      constexpr int HP = HDP / 2, RS = da::kThreads / HP;
      const int d = t % HP, r0 = t / HP;
      float* cs = ext + e_cs();
      if (d < half) {  // the angles once per (position, column pair)
        const float fr = expf(-(float)d * rope_coef);
        for (int s = r0; s < S; s += RS) {
          float sn, c;
          sincosf((float)(p + of[s]) * fr, &sn, &c);
          cs[s * hd + d] = c;
          cs[s * hd + half + d] = sn;
        }
      }
      __syncthreads();
      if (d < half) {
        int sq = (h0 + r0) % S;  // rows r0, r0 + RS, ...: their positions
        for (int r = r0; r < nh + S; r += RS) {
          const int s = r < nh ? sq : r - nh;
          float* x = r < nh ? qs + r * ldq : ke + s * hd;
          const float c = cs[s * hd + d], sn = cs[s * hd + half + d];
          const float x1 = x[d], x2 = x[d + half];
          x[d] = x1 * c - x2 * sn;
          x[d + half] = x2 * c + x1 * sn;
          sq += RS;
          while (sq >= S) sq -= S;
        }
      }
      __syncthreads();
    }
    if (blockIdx.y == 0 && h0 == 0) {  // the unit's first block
      for (int i = t; i < S * hd; i += da::kThreads) {
        const size_t dst = ((size_t)(b * S + i / hd) * KV + h) * hd + i % hd;
        if (x_dtype == kXF32) {
          static_cast<float*>(k_new)[dst] = ke[i];
          static_cast<float*>(v_new)[dst] = ve[i];
        } else {
          static_cast<__nv_bfloat16*>(k_new)[dst] = __float2bfloat16_rn(ke[i]);
          static_cast<__nv_bfloat16*>(v_new)[dst] = __float2bfloat16_rn(ve[i]);
        }
      }
    }
    if constexpr (QUANT) {
      __syncthreads();  // candidates stored before the round trip rewrites them
      for (int w = warp; w < 2 * S; w += da::kWarps) {
        float* e = (w < S ? ke : ve) + (w % S) * hd;
        float mx = 0.f;
        for (int d = lane; d < hd; d += 32) mx = fmaxf(mx, fabsf(e[d]));
        mx = da::warp_max(mx);
        const float sc = mx / 127.f;
        const float den = fmaxf(sc, 1e-8f);
        const float scb = __bfloat162float(__float2bfloat16_rn(sc));
        for (int d = lane; d < hd; d += 32) e[d] = rintf(e[d] / den) * scb;
      }
      __syncthreads();
    }
    // one thread per (row, column): f32 FMAs over hd, four running sums
    for (int i = t; i < nh * S; i += da::kThreads) {
      const int r = i / S, c = i % S;
      const float* qr = qs + r * ldq;
      const float* kr = ke + c * hd;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      if (hd % 4 == 0) {  // rows 16-byte aligned
#pragma unroll 4
        for (int d = 0; d < hd; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          a0 = fmaf(qv.x, kv.x, a0);
          a1 = fmaf(qv.y, kv.y, a1);
          a2 = fmaf(qv.z, kv.z, a2);
          a3 = fmaf(qv.w, kv.w, a3);
        }
      } else {
        for (int d = 0; d < hd; ++d) a0 = fmaf(qr[d], kr[d], a0);
      }
      ext[e_sc() + r * S + c] = ((a0 + a1) + (a2 + a3)) * scale;
    }
  }
  __device__ int ext_cols() const { return S; }
  __device__ bool ext_ok(const float* ext, int r, int c) const {
    return ext[e_ok() + ((h0 + r) % S) * S + c] != 0.f;
  }
  __device__ float ext_score(const float* ext, int r, int c) const {
    return ext[e_sc() + r * S + c];
  }
  __device__ float ext_value(const float* ext, int c, int d) const {
    return ext[e_v() + c * hd + d];
  }
  __device__ void store(int r, int d, float val) const {
    const int gr = h0 + r;
    out[(size_t)(b * S + gr % S) * H * hd + (size_t)(h * Gq + gr / S) * hd + d] =
        val;
  }
  __device__ void after_merge(float*, int, int, int) const {}
};

struct VerifyLaunch {
  const float *q, *k, *v;
  const void *kc, *vc, *ks, *vs;
  const int *pos, *offs;
  const int8_t* ext_ok;
  float* out;
  void *k_new, *v_new;
  int x_dtype, B, H, KV, hd, S, Sc, window, use_rope, splits, rows_per_split;
  float rope_coef, scale;
  const int* table;  // (B, P) page table, or null: a dense cache
  int ps, P;
};

template <typename TC, bool QUANT, bool WINDOW>
VerifyProb<TC, QUANT, WINDOW> make_prob(const VerifyLaunch& a) {
  VerifyProb<TC, QUANT, WINDOW> p = {};
  p.units = a.B * a.KV;
  p.Gq = a.KV > 0 ? a.H / a.KV : 1;
  p.G = p.Gq * a.S;
  p.hd = a.hd;
  p.rps = a.rows_per_split;
  p.vec = (a.hd * (int)sizeof(TC)) % 16 == 0 && da::aligned16(a.kc) &&
          da::aligned16(a.vc);
  p.scale = a.scale;
  p.kc = a.kc;
  p.vc = a.vc;
  p.q = a.q;
  p.k = a.k;
  p.v = a.v;
  p.ks = static_cast<const __nv_bfloat16*>(a.ks);
  p.vs = static_cast<const __nv_bfloat16*>(a.vs);
  p.pos = a.pos;
  p.offs = a.offs;
  p.ext_ok_g = a.ext_ok;
  p.out = a.out;
  p.k_new = a.k_new;
  p.v_new = a.v_new;
  p.x_dtype = a.x_dtype;
  p.H = a.H;
  p.KV = a.KV;
  p.S = a.S;
  p.Sc = a.Sc;
  p.window = a.window;
  p.use_rope = a.use_rope;
  p.rope_coef = a.rope_coef;
  p.pt.table = a.table;
  p.pt.ps = a.ps;
  p.pt.P = a.P;
  return p;
}

// Calls f(problem, (TC*)nullptr, std::integral_constant<int, HDP>()) for
// the cache dtype, window and hd of the launch, the problem's row groups
// sized by the rows a block carries at that HDP.
template <class F>
int with_prob(const VerifyLaunch& a, int cache_dtype, F&& f) {
  auto go = [&](auto tc, auto quant, auto win) {
    using TC = std::remove_const_t<std::remove_pointer_t<decltype(tc)>>;
    auto p = make_prob<TC, decltype(quant)::value, decltype(win)::value>(a);
    return da::with_hdp(a.hd, [&](auto hdp) {
      constexpr int HDP = decltype(hdp)::value;
      constexpr int MR = 16 * da::block_mtiles<decltype(p), TC, HDP>();
      p.rows = min(p.G, MR);
      p.hgroups = (p.G + MR - 1) / MR;
      return f(p, tc, hdp);
    });
  };
  const std::true_type yes;
  const std::false_type no;
  if (cache_dtype == da::kI8) {
    const int8_t* tc = nullptr;
    return a.window ? go(tc, yes, yes) : go(tc, yes, no);
  }
  if (cache_dtype == da::kBF16) {
    const __nv_bfloat16* tc = nullptr;
    return a.window ? go(tc, no, yes) : go(tc, no, no);
  }
  const float* tc = nullptr;
  return a.window ? go(tc, no, yes) : go(tc, no, no);
}

// the core (f32 q: split hi + lo on the tensor cores), or with max_clusters
// set its occupancy query
int dispatch(const VerifyLaunch& a, int cache_dtype, cudaStream_t st,
             int* max_clusters, int* route) {
  return with_prob(a, cache_dtype, [&](const auto& p, auto tc, auto hdp) {
    using TC = std::remove_const_t<std::remove_pointer_t<decltype(tc)>>;
    return da::launch_core<std::decay_t<decltype(p)>, TC, true,
                           decltype(hdp)::value>(p, a.splits, st, max_clusters,
                                                 route);
  });
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

// (b) RoPE + attention over the dense (B, Sc, KV, hd) cache (table null), or
// over a page pool (n_pages, ps, KV, hd) through the (B, P) int32 page table
// `table`, Sc = P * ps, split into row ranges (one cluster of 1..16 splits
// per (slot, KV head) and row group) + the S extension columns under ext_ok
// + raw candidates out. splits * rows_per_split must cover the Sc cache
// rows, rows_per_split a multiple of 64; 1 <= S <= 64. cache_dtype: 0 f32,
// 1 bf16, 2 int8 (with bf16 scales); x_dtype: 0 f32, 1 bf16. Writes the
// route of the kernel launched (0 f32 FMAs, 1 tensor cores) to *route.
extern "C" int verify_attn_launch(const float* q, const float* k, const float* v,
                                  const void* kc, const void* vc, const void* ks,
                                  const void* vs, int cache_dtype,
                                  const int* pos, const int* offs,
                                  const int8_t* ext_ok, float* out,
                                  void* k_new, void* v_new, int x_dtype, int B,
                                  int H, int KV, int hd, int S, int Sc,
                                  const int* table, int ps, int P,
                                  int window, int use_rope, int splits,
                                  int rows_per_split, float rope_coef,
                                  float scale, int* route, void* stream) {
  if (KV < 1 || H % KV != 0 || hd < 1 || hd > da::kMaxHD || hd % 2 != 0 ||
      S < 1 || S > 64 || (long long)splits * rows_per_split < Sc ||
      (table && (ps < 1 || P < 1 || (long long)P * ps != Sc)))
    return (int)cudaErrorInvalidValue;
  const VerifyLaunch a = {q,     k,      v,      kc,     vc,     ks,
                        vs,    pos,    offs,   ext_ok, out,    k_new,
                        v_new, x_dtype, B,     H,      KV,     hd,
                        S,     Sc,     window, use_rope, splits, rows_per_split,
                        rope_coef, scale, table, ps, P};
  return dispatch(a, cache_dtype, static_cast<cudaStream_t>(stream), nullptr,
                  route);
}

// Query rows one block of the attention kernel carries for this cache dtype
// and hd (64 on the tensor cores up to hd 64, 32 at hd 128, 16 in f32).
extern "C" int verify_attn_block_rows(int cache_dtype, int hd) {
  if (hd < 1 || hd > da::kMaxHD) return 0;
  VerifyLaunch a = {};
  a.hd = hd;
  a.B = a.H = a.KV = a.S = 1;
  return with_prob(a, cache_dtype, [&](const auto&, auto tc, auto hdp) {
    using TC = std::remove_const_t<std::remove_pointer_t<decltype(tc)>>;
    using Prob = VerifyProb<TC, false, false>;
    return 16 * da::block_mtiles<Prob, TC, decltype(hdp)::value>();
  });
}

// How many clusters of `splits` blocks of the attention kernel for this
// cache dtype, hd, group, S and window (0 / 1) fit on the card at once;
// written to *out.
extern "C" int verify_attn_max_clusters(int cache_dtype, int hd, int group,
                                        int S, int window, int splits,
                                        int* out) {
  if (hd < 1 || hd > da::kMaxHD || group < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  VerifyLaunch a = {};
  a.B = 1;
  a.KV = 1;
  a.H = group;
  a.hd = hd;
  a.S = S;
  a.Sc = 1;
  a.window = window;
  a.splits = splits;
  a.rows_per_split = da::kChunk;
  a.rope_coef = a.scale = 1.f;
  return dispatch(a, cache_dtype, nullptr, out, nullptr);
}
