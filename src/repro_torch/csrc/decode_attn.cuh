// One decode-attention core for Hopper (sm_90a), shared by flash_decode.cu,
// the attention launch of fused_decode.cu and that of fused_verify.cu.
//
// What it computes, for each unit u (a KV row of flash_decode, a (slot, KV
// head) pair of the fused decode and verify) and the G query rows that
// share it (query heads; in the verify, heads times verified positions):
//   softmax(q K^T * scale) V
// over the unit's cache rows [0, n) that the problem lets attend, with the
// running max, sum and accumulator in f32, the finite -1e30 mask, and
// masked probabilities zeroed explicitly (a wholly masked chunk would
// otherwise add exp(0) = 1). n is read from device memory by every block.
// The TPU kernels it replaces are src/repro/kernels/flash_decode.py:_kernel
// and the attention parts of src/repro/kernels/fused_decode.py:_decode_kernel
// and :_verify_kernel.
//
// What bounds it on the H100: bytes, and in practice latency. A cache row
// of hd bf16 keys and values feeds 4 * G * hd flops: ~4 flops per byte at
// G = 8, against the ~295 the card needs before its tensor cores limit. At
// the serving shapes (a few MB of live rows) one DRAM round trip is most of
// the time, so the design keeps every row of a block in flight at once and
// pays the round trip once:
//   * Grid: (units x row groups of <= 16 * kMTiles rows, splits). The
//     splits of a unit split its cache rows into ranges of whole 64-row
//     chunks and run as one thread block cluster (<= 16 blocks). A block
//     whose rows lie at or past n loads nothing and only takes part in the
//     merge.
//   * Loads: each 64-row chunk of K and V goes into a ring of kStages = 2
//     chunk slots in shared memory by 16-byte cp.async copies (element
//     copies where rows are not 16-byte aligned); rows at or past n are
//     zero-filled, never left stale (a masked p of 0 times a stale
//     non-finite V is NaN on a tensor core). The next chunk loads while one
//     is multiplied; at the serving shapes a split is one or two chunks,
//     and two slots (not three) leave room for 4 blocks on an SM. A block
//     of several row tiles (below) spends longer on a chunk and keeps three
//     slots, so both chunks of a two-chunk split load from the start. The
//     problem computes a row's address once per row.
//   * Math, bf16 and int8 caches (route "tc"): mma.sync.m16n8k16 bf16 with
//     f32 sums. The query rows are the MMA's M side (8 of 16 rows live at
//     G = 8), cache rows its n8 side, hd its k16 side; each of the 4 warps
//     takes 16 rows of every chunk. S = Q K^T from q fragments held in
//     registers and K fragments by ldmatrix; P V reuses the S accumulators
//     as A fragments, V by ldmatrix.trans. A problem with kMTiles > 1 (the
//     verify: 40 rows at G = 8 and 5 positions) has a block carry up to
//     kMTiles m16 tiles of rows, so that each K/V chunk is read from device
//     memory once per unit, not once per 16 rows: each warp runs every
//     m16 tile against its 16 cache rows, the K and V fragments loaded once
//     for all of them, the q fragments by ldmatrix from a bf16 hi / lo copy
//     in shared memory (held in registers they would not fit beside the
//     accumulators); at most 256 / HDP tiles, so that the accumulators stay
//     at <= 128 registers (f32 caches: one tile). Exactness as in the TPU
//     kernels:
//       - f32 q (the fused decode's, and flash_decode's f32 queries) is split
//         q = q_hi + q_lo, two bf16 products into one f32 accumulator; bf16
//         q is exact as it is;
//       - p stays f32 in effect: p = p_hi + p_lo, two products, as in
//         flash_attn_tc (|p - p_hi - p_lo| <= 2^-16 p);
//       - an int8 cache enters the MMA as its exact int8 values in bf16 (the
//         fragments built from shared memory); the per-row k scale
//         multiplies the score after Q K^T and the v scale is folded into p
//         before P V (l sums the unfolded p). A product k * k_scale would
//         need 15 mantissa bits, which a bf16 operand does not have.
//   * Math, f32 caches (route "fma"): the same fragment layout, computed by
//     f32 FMAs (a tensor core would change f32 products).
//   * Merge: the 4 warps of a block merge their (max, sum, acc) through
//     shared memory into the block's partial. After a cluster barrier the
//     blocks of the cluster merge the partials through distributed shared
//     memory, in split order, each block taking a share of the outputs (per
//     split an 8-byte (max, sum) and a 16-byte sum load, those of up to 8
//     splits all in flight before the sums, in few enough registers that
//     the compiler keeps them in flight): deterministic, no workspace in
//     device memory, no atomics, no fences. (With several row tiles a
//     block takes whole rows: their weights once per row, then the
//     columns.) A second
//     cluster barrier, without release semantics (it orders no memory),
//     keeps every block's shared memory alive until its peers have read it.
//     The first barrier also orders the fused decode's write-back of the new
//     K/V after every block of the unit has read its rows.
//   * Extension columns (kExt): ext_cols() columns beside the cache (the
//     fused decode's new token, the verify's S new keys), scored in f32 by
//     the problem, merged after the splits in f32 FMAs under ext_ok.
//   * Rows that see different cache rows (kRowMask: the verify under a
//     sliding window, whose lower edge moves with each row's position): the
//     problem's row_key(r) once per row and ok_row(key, jj) per (row, cache
//     row) beside ok(jj); only such a problem pays for it.
//
// A problem type P supplies the unit's rows and what surrounds the core:
//   int units, hgroups, G (query rows per unit), hd, rps (rows per split, a
//   multiple of kChunk), vec (16-byte copies allowed); float scale; const
//   void *kc, *vc (the cache pools);
//   static constexpr bool kQuant (int8 cache with per-row scales),
//                         kExt (extension columns beside the cache),
//                         kRowMask (visibility per query row);
//   static constexpr int kMTiles (m16 row tiles a block may carry);
//   int ext_floats()          shared floats the problem keeps (host)
//   int begin(unit, h0, nh)   per-block set-up; returns n, the rows visited
//   bool ok(jj)               row jj < n attends (every query row)
//   int row_key(ext, r), bool ok_row(key, jj)   (kRowMask) row r's own mask
//   size_t row(jj)            element offset of row jj in kc / vc
//   float kscale(jj), vscale(jj)     (kQuant) the row's scales, in f32
//   void load_q<HDP, MR>(qs, ldq, ext, t)  q of the nh rows as f32 rows of
//                                    qs (zeros past hd up to HDP, and in
//                                    rows nh .. MR), and anything
//                                    the problem keeps in ext; all threads,
//                                    every load issued before the first
//                                    store (a store to shared memory between
//                                    them would serialize the round trips)
//   void prepare<HDP, MR>(qs, ldq, ext, t)  after load_q and a barrier
//   (kExt) int ext_cols(); bool ext_ok(ext, r, c); float ext_score(ext, r,
//          c), ext_value(ext, c, d)   the extension columns
//   void store(r, d, v)              one output element
//   void after_merge(ext, split, hg, t)  after the first cluster barrier
// A problem whose cache is a page pool (the fused decode's and the
// verify's) keeps a PageTable (below) and maps row(jj) through it; the core
// never sees the table.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace da {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;         // cache rows per ring slot
constexpr int kStages = 2;         // ring slots
constexpr int kMaxSplits = 16;     // blocks of one cluster (the H100 takes 16)
constexpr int kMaxHeads = 16;      // rows of one m16 tile: the MMA's M side
constexpr int kMaxHD = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
static_assert(kMaxHD <= kThreads, "a thread per column of a row");

enum CacheType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// two int8 values (lo at the lower address) as a bf16 pair: exact
__device__ __forceinline__ uint32_t i8x2_bf16(int8_t lo, int8_t hi) {
  return ptx::pack_bf16((float)lo, (float)hi);
}

// f32 pair as bf16 hi + lo halves (hi = bf16(x), lo = bf16(x - hi))
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = ptx::pack_bf16(x0 - hf.x, x1 - hf.y);
}

// A slot's page table, as the fused decode and verify problems read it.
// With a table, cache row jj of slot b lies at physical row
//   table[b * P + jj / ps] * ps + jj % ps
// of the page pool (n_pages, ps, KV, hd); a null table is the dense cache,
// whose rows the problem addresses itself. load() reads the entries that
// cover the block's split range [rbeg, rbeg + rps) once, into shared
// memory: every thread of the block calls it in begin(), where its loads
// are in flight together with the problem's position read, and one barrier
// follows (block-uniform: a dense launch skips it). A row outside that
// range, or a range of more than kMaxBlockPages pages, reads its entry from
// device memory. The problem's choice between table and none is a branch on
// a uniform pointer, taken where rows are addressed, never around an MMA.
constexpr int kMaxBlockPages = 64;
static_assert(kMaxBlockPages <= kThreads, "one entry per thread");

struct PageTable {
  const int* table;  // (B, P) int32 physical page of each logical page; or null
  int ps, P;         // rows per page, table width
  const int* row_tbl;  // this slot's row of the table
  const int* held;     // the block's entries, in shared memory
  int page0, npg;      // first logical page held, pages held

  __device__ void load(int b, int rbeg, int rps, int t) {
    __shared__ int s_pages[kMaxBlockPages];
    row_tbl = table + (size_t)b * P;
    page0 = rbeg / ps;
    const int pend = min(P, (rbeg + rps + ps - 1) / ps);
    npg = pend > page0 && pend - page0 <= kMaxBlockPages ? pend - page0 : 0;
    const int e = t < npg ? row_tbl[page0 + t] : 0;
    if (t < npg) s_pages[t] = e;
    held = s_pages;
    __syncthreads();
  }
  __device__ size_t phys(int jj) const {
    const int lp = jj / ps;
    const unsigned i = (unsigned)(lp - page0);
    const int pg = i < (unsigned)npg ? held[i] : row_tbl[lp];
    return (size_t)pg * ps + (jj - lp * ps);
  }
};

// m16 row tiles a block of problem P carries on cache type TC at hd padded
// to HDP: P::kMTiles on the tensor cores, at most 256 / HDP (the
// accumulators' registers); one on the f32 route.
template <class P, typename TC, int HDP>
__host__ __device__ constexpr int block_mtiles() {
  return sizeof(TC) == 4 ? 1
         : P::kMTiles * HDP <= 256 ? P::kMTiles : 256 / HDP;
}

// Shared-memory layout, in bytes from the start of the dynamic buffer, for
// MT m16 tiles of query rows (MR = 16 MT rows).
template <typename TC, int HDP, int MT = 1>
struct Layout {
  static constexpr int MR = 16 * MT;
  // ring slots: a block of several row tiles spends longer on a chunk, so
  // it keeps one more chunk in flight (both of a two-chunk split)
  static constexpr int kSt = MT == 1 ? kStages : kStages + 1;
  static constexpr int LD = HDP + 16 / (int)sizeof(TC);  // ring row stride
  // q row stride: f32 rows, which with MT > 1 become the bf16 hi and lo
  // rows of LQB elements in the same bytes once prepared
  static constexpr int LQ = MT == 1 ? HDP + 4 : HDP + 8;
  static constexpr int LQB = HDP + 8;
  static constexpr int kTile = kChunk * LD * (int)sizeof(TC);
  static constexpr int kRing = kSt * 2 * kTile;          // K and V per slot
  // the warps' partials (max, sum per row, acc rows of HDP + 4 floats, so
  // that the 8 rows of a store fall in different banks) take the ring's
  // place
  static constexpr int LW = HDP + 4;
  static constexpr int kWarp = 2 * MR + MR * LW;
  static constexpr int kWarpPart = kWarps * kWarp * 4;
  static constexpr int kUnion = kRing > kWarpPart ? kRing : kWarpPart;
  static constexpr int kScales = kUnion;                  // [kSt][2][kChunk] f32
  static constexpr int kQ = kScales + kSt * 2 * kChunk * 4;
  // with MT > 1 the block's partial (after the chunks) takes the q rows'
  // place (dead once the fragments are built): MR (HDP + 4) <= MR LQ floats
  static constexpr int kStat = MT == 1 ? kQ + MR * LQ * 4 : kQ;  // [MR] float2 (m, l)
  static constexpr int kAcc = kStat + MR * 16;            // [MR][HDP] f32
  static constexpr int kExt = MT == 1 ? kAcc + MR * HDP * 4 : kQ + MR * LQ * 4;
  static constexpr int bytes(int ext_floats) {
    return kExt + ((ext_floats + 3) / 4) * 16;
  }
};

// Scores of one warp's 16 rows of a chunk, f32 cache: the fragment layout
// of the tensor-core route (s[j][e]: head g + 8 (e >> 1), row 8 j + 2 t +
// (e & 1)), by f32 FMAs over hd.
template <int HDP>
__device__ __forceinline__ void fma_scores(float (&s)[2][4], const float* qs,
                                           int ldq, const float* Kb, int ld,
                                           int g, int tq, int nh) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = g + 8 * (e >> 1);
      float acc = 0.f;
      if (head < nh) {
        const float* qr = qs + head * ldq;
        const float* kr = Kb + (8 * j + 2 * tq + (e & 1)) * ld;
#pragma unroll
        for (int d = 0; d < HDP; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 b = *reinterpret_cast<const float4*>(kr + d);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      }
      s[j][e] = acc;
    }
}

template <class P, typename TC, bool QSPLIT, int HDP>
__global__ void __launch_bounds__(kThreads) decode_attn_core(const P prm) {
  constexpr int MT = block_mtiles<P, TC, HDP>();
  typedef Layout<TC, HDP, MT> Lay;
  constexpr int MR = Lay::MR;   // query rows per block
  constexpr int STG = Lay::kSt;  // ring slots
  constexpr int LD = Lay::LD, LQ = Lay::LQ, LQB = Lay::LQB;
  constexpr int KS = HDP / 16;  // k16 steps of Q K^T
  constexpr int ND = HDP / 8;   // n8 tiles of the output over hd
  constexpr bool kTC = sizeof(TC) != 4;
  constexpr bool kI8 = sizeof(TC) == 1;
  static_assert(kTC || MT == 1, "the f32 route carries one row tile");
  extern __shared__ __align__(16) unsigned char smem[];
  TC* ring = reinterpret_cast<TC*>(smem);
  float* scl = reinterpret_cast<float*>(smem + Lay::kScales);
  float* qs = reinterpret_cast<float*>(smem + Lay::kQ);
  float* stat = reinterpret_cast<float*>(smem + Lay::kStat);
  float* bacc = reinterpret_cast<float*>(smem + Lay::kAcc);
  float* ext = reinterpret_cast<float*>(smem + Lay::kExt);

  P pb = prm;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int hg = (int)blockIdx.x % pb.hgroups;
  const int unit = (int)blockIdx.x / pb.hgroups;
  const int split = (int)blockIdx.y, splits = (int)gridDim.y;
  const int h0 = hg * MR;
  const int nh = min(MR, pb.G - h0);
  // m16 tiles with live rows (warp-uniform)
  const int mtn = MT == 1 ? 1 : (nh + 15) / 16;
  const int hd = pb.hd;
  const int n = pb.begin(unit, h0, nh);
  const int rbeg = split * pb.rps;
  const int rend = min(n, rbeg + pb.rps);
  const int nchunks = rend > rbeg ? (rend - rbeg + kChunk - 1) / kChunk : 0;

  // pad columns hd .. HDP of every ring tile are read by the products and
  // never copied: zero them once
  if (hd < HDP) {
    const int padw = HDP - hd;
    for (int i = t; i < STG * 2 * kChunk * padw; i += kThreads)
      ring[(i / padw) * LD + hd + i % padw] = zero_of<TC>();
  }

  const TC* kc = static_cast<const TC*>(pb.kc);
  const TC* vc = static_cast<const TC*>(pb.vc);
  constexpr int EPC = 16 / (int)sizeof(TC);  // elements per 16-byte copy
  const int cpr = pb.vec ? hd / EPC : 0;     // copies per row
  // the scales of this thread's row (t < kChunk) of the chunks in flight:
  // loaded as the chunk is issued, stored beside it when it is consumed
  float pk[STG - 1], pv[STG - 1];
#pragma unroll
  for (int i = 0; i < STG - 1; ++i) pk[i] = pv[i] = 0.f;

  auto issue = [&](int c, float& sk, float& sv) {
    const int k0 = rbeg + c * kChunk;
    TC* Kd = ring + (c % STG) * 2 * kChunk * LD;
    TC* Vd = Kd + kChunk * LD;
    if (pb.vec) {
      int r_last = -1;
      size_t off = 0;
      for (int i = t; i < kChunk * cpr; i += kThreads) {
        const int r = i / cpr, seg = (i % cpr) * EPC;
        const bool ok = k0 + r < rend;
        if (ok && r != r_last) {  // one address per row
          off = pb.row(k0 + r);
          r_last = r;
        }
        ptx::cp_async16(Kd + r * LD + seg, ok ? kc + off + seg : kc, ok);
        ptx::cp_async16(Vd + r * LD + seg, ok ? vc + off + seg : vc, ok);
      }
    } else {
      for (int r = t / 32; r < kChunk; r += kWarps) {
        const bool ok = k0 + r < rend;
        const size_t off = ok ? pb.row(k0 + r) : 0;
        for (int d = lane; d < hd; d += 32) {
          Kd[r * LD + d] = ok ? kc[off + d] : zero_of<TC>();
          Vd[r * LD + d] = ok ? vc[off + d] : zero_of<TC>();
        }
      }
    }
    if constexpr (P::kQuant) {
      if (t < kChunk && k0 + t < rend) {
        sk = pb.kscale(k0 + t);
        sv = pb.vscale(k0 + t);
      } else {
        sk = sv = 0.f;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STG - 1; ++s) {
    if (s < nchunks) issue(s, pk[s], pv[s]);
    ptx::cp_async_commit();
  }

  // q (and the problem's own set-up) while the first chunks load
  pb.template load_q<HDP, MR>(qs, LQ, ext, t);
  __syncthreads();
  pb.template prepare<HDP, MR>(qs, LQ, ext, t);
  __syncthreads();

  // q A fragments: hi and (QSPLIT) lo, in registers for one row tile; for
  // more, as bf16 hi and lo rows in place of the f32 rows (ldmatrix per use)
  uint32_t qa[MT == 1 ? KS : 1][4], qb[MT == 1 ? KS : 1][4];
  const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(qs);
  const __nv_bfloat16* ql = qh + MR * LQB;
  if constexpr (kTC && MT == 1) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* r0 = qs + g * LQ + 16 * ks + 2 * tq;
      const float* r1 = r0 + 8 * LQ;
      const float2 x0 = *reinterpret_cast<const float2*>(r0);
      const float2 x1 = *reinterpret_cast<const float2*>(r1);
      const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(r1 + 8);
      if constexpr (QSPLIT) {
        split2(x0.x, x0.y, qa[ks][0], qb[ks][0]);
        split2(x1.x, x1.y, qa[ks][1], qb[ks][1]);
        split2(x2.x, x2.y, qa[ks][2], qb[ks][2]);
        split2(x3.x, x3.y, qa[ks][3], qb[ks][3]);
      } else {  // q came in bf16: exact
        qa[ks][0] = ptx::pack_bf16(x0.x, x0.y);
        qa[ks][1] = ptx::pack_bf16(x1.x, x1.y);
        qa[ks][2] = ptx::pack_bf16(x2.x, x2.y);
        qa[ks][3] = ptx::pack_bf16(x3.x, x3.y);
      }
    }
  } else if constexpr (MT > 1) {
    constexpr int NQ = MR * HDP / kThreads;
    float xq[NQ];
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int i = t + u * kThreads;
      xq[u] = qs[(i / HDP) * LQ + i % HDP];
    }
    __syncthreads();  // every f32 row read before the bf16 rows overwrite it
    __nv_bfloat16* wh = reinterpret_cast<__nv_bfloat16*>(qs);
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int i = t + u * kThreads, o = (i / HDP) * LQB + i % HDP;
      const __nv_bfloat16 hi = __float2bfloat16_rn(xq[u]);
      wh[o] = hi;
      wh[MR * LQB + o] = __float2bfloat16_rn(xq[u] - __bfloat162float(hi));
    }
    __syncthreads();
  }
  // (kRowMask) each of this thread's query rows: its key, once
  int key[MT][2];
  if constexpr (P::kRowMask) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) key[mt][i] = pb.row_key(ext, 16 * mt + g + 8 * i);
  }

  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float scale = pb.scale;

#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    ptx::cp_async_wait<STG - 2>();
    const int st = c % STG;
    if constexpr (P::kQuant) {
      if (t < kChunk) {
        scl[(st * 2) * kChunk + t] = pk[0];
        scl[(st * 2 + 1) * kChunk + t] = pv[0];
      }
#pragma unroll
      for (int i = 0; i + 1 < STG - 1; ++i) {
        pk[i] = pk[i + 1];
        pv[i] = pv[i + 1];
      }
    }
    __syncthreads();  // chunk c visible to all; chunk c - 1 consumed by all
    if (c + STG - 1 < nchunks)
      issue(c + STG - 1, pk[STG - 2], pv[STG - 2]);
    ptx::cp_async_commit();

    const int w0 = rbeg + c * kChunk + 16 * warp;  // this warp's first row
    if (w0 >= rend) continue;                      // warp-uniform
    const TC* Kb = ring + st * 2 * kChunk * LD + 16 * warp * LD;
    const TC* Vb = Kb + kChunk * LD;
    const float* sk = scl + (st * 2) * kChunk + 16 * warp;
    const float* sv = sk + kChunk;

    float s[MT][2][4];
    if constexpr (kTC) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];  // b0, b1 of row tiles 0 and 1
        if constexpr (kI8) {
          const int8_t* K8 = reinterpret_cast<const int8_t*>(Kb);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int8_t* p = K8 + (8 * j + g) * LD + 16 * ks + 2 * tq;
            kf[2 * j] = i8x2_bf16(p[0], p[1]);
            kf[2 * j + 1] = i8x2_bf16(p[8], p[9]);
          }
        } else {
          ptx::ldmatrix_x4(kf, Kb + (lane % 8 + (lane / 16) * 8) * LD +
                                   16 * ks + ((lane / 8) % 2) * 8);
        }
        if constexpr (MT == 1) {
          ptx::mma_bf16(s[0][0], qa[ks], kf[0], kf[1]);
          ptx::mma_bf16(s[0][1], qa[ks], kf[2], kf[3]);
          if constexpr (QSPLIT) {
            ptx::mma_bf16(s[0][0], qb[ks], kf[0], kf[1]);
            ptx::mma_bf16(s[0][1], qb[ks], kf[2], kf[3]);
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt >= mtn) break;  // warp-uniform
            const int o = (16 * mt + lane % 16) * LQB + 16 * ks + (lane / 16) * 8;
            uint32_t a[4];
            ptx::ldmatrix_x4(a, qh + o);
            ptx::mma_bf16(s[mt][0], a, kf[0], kf[1]);
            ptx::mma_bf16(s[mt][1], a, kf[2], kf[3]);
            if constexpr (QSPLIT) {
              ptx::ldmatrix_x4(a, ql + o);
              ptx::mma_bf16(s[mt][0], a, kf[0], kf[1]);
              ptx::mma_bf16(s[mt][1], a, kf[2], kf[3]);
            }
          }
        }
      }
    } else {
      fma_scores<HDP>(s[0], qs, LQ, reinterpret_cast<const float*>(Kb), LD, g,
                      tq, nh);
    }

    // scale (and the k scale), mask, online softmax over the warp's rows
    bool okr[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = w0 + 8 * j + 2 * tq + u;
        okr[j][u] = jj < rend && pb.ok(jj);
      }
    // visible: cache row (j, u) for query row i of tile mt
    auto vis = [&](int mt, int i, int j, int u) {
      if constexpr (P::kRowMask)
        return okr[j][u] && pb.ok_row(key[mt][i], w0 + 8 * j + 2 * tq + u);
      else
        return okr[j][u];
    };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= mtn) break;  // warp-uniform
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int rr = 8 * j + 2 * tq + u;
          const float f = P::kQuant ? scale * sk[rr] : scale;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float x = vis(mt, i, j, u) ? s[mt][j][2 * i + u] * f : kNegInf;
            s[mt][j][2 * i + u] = x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[mt][i], mx[i]);
        alpha[i] = expf(m[mt][i] - m_new);
        m[mt][i] = m_new;
        l[mt][i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int rr = 8 * j + 2 * tq + u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float p =
                vis(mt, i, j, u) ? expf(s[mt][j][2 * i + u] - m[mt][i]) : 0.f;
            l[mt][i] += p;
            // the v scale folded into p for P V (l keeps the unfolded p)
            s[mt][j][2 * i + u] = P::kQuant ? p * sv[rr] : p;
          }
        }
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[mt][d][0] *= alpha[0];
        acc[mt][d][1] *= alpha[0];
        acc[mt][d][2] *= alpha[1];
        acc[mt][d][3] *= alpha[1];
      }
    }

    if constexpr (kTC) {
      // O += P V, P = p_hi + p_lo straight from the S fragments
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split2(s[mt][0][0], s[mt][0][1], ph[mt][0], pl[mt][0]);
        split2(s[mt][0][2], s[mt][0][3], ph[mt][1], pl[mt][1]);
        split2(s[mt][1][0], s[mt][1][1], ph[mt][2], pl[mt][2]);
        split2(s[mt][1][2], s[mt][1][3], ph[mt][3], pl[mt][3]);
      }
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t vf[4];  // b0, b1 of hd tiles d and d + 1
        if constexpr (kI8) {
          const int8_t* V8 = reinterpret_cast<const int8_t*>(Vb);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int8_t* p = V8 + (2 * tq) * LD + 8 * (d + u) + g;
            vf[2 * u] = i8x2_bf16(p[0], p[LD]);
            vf[2 * u + 1] = i8x2_bf16(p[8 * LD], p[9 * LD]);
          }
        } else {
          ptx::ldmatrix_x4_trans(
              vf, Vb + (lane % 8 + ((lane / 8) % 2) * 8) * LD + 8 * d +
                      (lane / 16) * 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt >= mtn) break;  // warp-uniform
          ptx::mma_bf16(acc[mt][d], ph[mt], vf[0], vf[1]);
          ptx::mma_bf16(acc[mt][d], pl[mt], vf[0], vf[1]);
          ptx::mma_bf16(acc[mt][d + 1], ph[mt], vf[2], vf[3]);
          ptx::mma_bf16(acc[mt][d + 1], pl[mt], vf[2], vf[3]);
        }
      }
    } else {
      // O += P V by FMAs: p of row rr comes from the quad lane that holds it
      const float* Vf = reinterpret_cast<const float*>(Vb);
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int j = rr / 8, u = rr % 2, src = 4 * g + (rr % 8) / 2;
        const float pa = __shfl_sync(0xffffffffu, s[0][j][u], src);
        const float pb2 = __shfl_sync(0xffffffffu, s[0][j][2 + u], src);
        const float* vr = Vf + rr * LD + 2 * tq;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const float2 v = *reinterpret_cast<const float2*>(vr + 8 * d);
          acc[0][d][0] = fmaf(pa, v.x, acc[0][d][0]);
          acc[0][d][1] = fmaf(pa, v.y, acc[0][d][1]);
          acc[0][d][2] = fmaf(pb2, v.x, acc[0][d][2]);
          acc[0][d][3] = fmaf(pb2, v.y, acc[0][d][3]);
        }
      }
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials take its place

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 1);
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 2);
    }
  constexpr int LW = Lay::LW, WS = Lay::kWarp;
  {
    float* wp = reinterpret_cast<float*>(smem) + warp * WS;
    float* wacc = wp + 2 * MR;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (tq == 0) {
        wp[16 * mt + g] = m[mt][0];
        wp[16 * mt + g + 8] = m[mt][1];
        wp[MR + 16 * mt + g] = l[mt][0];
        wp[MR + 16 * mt + g + 8] = l[mt][1];
      }
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wacc[(16 * mt + g + 8 * (e >> 1)) * LW + 8 * d + 2 * tq + (e & 1)] =
              acc[mt][d][e];
    }
  }
  __syncthreads();
  // the block's partial: the 4 warps merged, in warp order
  for (int i = t; i < nh * (HDP / 4); i += kThreads) {
    const int head = i / (HDP / 4), c4 = 4 * (i % (HDP / 4));
    const float* wp = reinterpret_cast<const float*>(smem);
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wp[w * WS + head]);
    float L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wp[w * WS + head] - M);
      L += wp[w * WS + MR + head] * f;
      const float4 x = *reinterpret_cast<const float4*>(
          wp + w * WS + 2 * MR + head * LW + c4);
      a.x += x.x * f;
      a.y += x.y * f;
      a.z += x.z * f;
      a.w += x.w * f;
    }
    *reinterpret_cast<float4*>(bacc + head * HDP + c4) = a;
    if (c4 == 0) *reinterpret_cast<float2*>(stat + 2 * head) = make_float2(M, L);
  }

  ptx::cluster_sync();  // every block's partial is written; every row read
  pb.after_merge(ext, split, hg, t);
  // the outputs, each block a share: (row, 4 columns) groups split, split +
  // splits, ...; the partials added in split order, then the extension
  // columns. Every split's (m, l) and the first 8 splits' sums are loaded
  // at once, all in flight, so a cluster of up to 8 costs one round trip
  // (64 registers of loads).
  constexpr int kBatch = 8;
  if constexpr (MT > 1) {
    // several row tiles: each block takes whole rows (split, split +
    // splits, ...). Pass 1, a warp per row, its lanes over the splits and
    // the extension columns: the row's max (shuffles), each split's weight
    // e^(m - M) / L and each column's p / L, into the free ring; pass 2, a
    // thread per (row, 4 columns): the weighted sums, in split order, then
    // the extension columns.
    constexpr int kRowW = kMaxSplits + 64;  // weights per row
    float* wrow = reinterpret_cast<float*>(smem);
    const int mine = (nh - split + splits - 1) / splits;
    const int ncol = P::kExt ? pb.ext_cols() : 0;
    constexpr int kIt = (kMaxSplits + 64 + 31) / 32;  // terms per lane
    for (int j = warp; j < mine; j += kWarps) {
      const int head = split + splits * j;
      // term k < splits: split k's (m, l); k >= splits: extension column
      // k - splits, its score (l < 0 marks a live column)
      float v[kIt], lv[kIt], mx = kNegInf;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int k = lane + 32 * it;
        v[it] = kNegInf;
        lv[it] = 0.f;
        if (k < splits) {
          const float2 ml = ptx::ld_cluster_f32x2(stat + 2 * head, k);
          v[it] = ml.x;
          lv[it] = ml.y;
        } else if (k < splits + ncol && pb.ext_ok(ext, head, k - splits)) {
          v[it] = pb.ext_score(ext, head, k - splits);
          lv[it] = -1.f;
        }
        mx = fmaxf(mx, v[it]);
      }
      const float M = warp_max(mx);
      float f[kIt], L = 0.f;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int k = lane + 32 * it;
        const bool live = k < splits || lv[it] < 0.f;  // masked: p = 0
        f[it] = live ? expf(v[it] - M) : 0.f;
        L += k < splits ? lv[it] * f[it] : f[it];
      }
      const float inv = 1.f / fmaxf(warp_sum(L), 1e-20f);
      float* wr = wrow + j * kRowW;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int k = lane + 32 * it;
        if (k < splits)
          wr[k] = f[it] * inv;
        else if (k < splits + ncol)
          wr[kMaxSplits + k - splits] = f[it] * inv;
      }
    }
    __syncthreads();
    for (int i = t; i < mine * (HDP / 4); i += kThreads) {
      const int j = i / (HDP / 4), c4 = 4 * (i % (HDP / 4));
      if (c4 >= hd) continue;
      const int head = split + splits * j;
      const float* wr = wrow + j * kRowW;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      float4 ax[kBatch];
#pragma unroll
      for (int b0 = 0; b0 < kMaxSplits; b0 += kBatch) {
        if (b0 >= splits) break;
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (b0 + u < splits)
            ax[u] = ptx::ld_cluster_f32x4(bacc + head * HDP + c4, b0 + u);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (b0 + u < splits) {
            const float f = wr[b0 + u];
            o[0] += ax[u].x * f;
            o[1] += ax[u].y * f;
            o[2] += ax[u].z * f;
            o[3] += ax[u].w * f;
          }
        }
      }
      if constexpr (P::kExt) {
        for (int ce = 0; ce < pb.ext_cols(); ++ce) {
          const float pe = wr[kMaxSplits + ce];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] += pe * pb.ext_value(ext, ce, c4 + e);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c4 + e < hd) pb.store(head, c4 + e, o[e]);
    }
    ptx::cluster_sync_relaxed();
    return;
  }
  const int groups = nh * (HDP / 4);
  for (int i = t * splits + split; i < groups; i += kThreads * splits) {
    const int head = i / (HDP / 4), c4 = 4 * (i % (HDP / 4));
    if (c4 >= hd) continue;
    float2 ml[kMaxSplits];
    float4 ax[kBatch];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) ml[sp] = ptx::ld_cluster_f32x2(stat + 2 * head, sp);
#pragma unroll
    for (int sp = 0; sp < kBatch; ++sp)
      if (sp < splits) ax[sp] = ptx::ld_cluster_f32x4(bacc + head * HDP + c4, sp);
    float M = kNegInf;
    if constexpr (P::kExt) {
      for (int ce = 0; ce < pb.ext_cols(); ++ce)
        if (pb.ext_ok(ext, head, ce)) M = fmaxf(M, pb.ext_score(ext, head, ce));
    }
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits) M = fmaxf(M, ml[sp].x);
    float L = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int b0 = 0; b0 < kMaxSplits; b0 += kBatch) {
      if (b0 >= splits) break;
      if (b0 > 0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (b0 + u < splits)
            ax[u] = ptx::ld_cluster_f32x4(bacc + head * HDP + c4, b0 + u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (b0 + u < splits) {
          const float f = expf(ml[b0 + u].x - M);
          L += ml[b0 + u].y * f;
          o[0] += ax[u].x * f;
          o[1] += ax[u].y * f;
          o[2] += ax[u].z * f;
          o[3] += ax[u].w * f;
        }
      }
    }
    if constexpr (P::kExt) {
      for (int ce = 0; ce < pb.ext_cols(); ++ce) {
        if (!pb.ext_ok(ext, head, ce)) continue;  // masked: p = 0
        const float pe = expf(pb.ext_score(ext, head, ce) - M);
        L += pe;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] += pe * pb.ext_value(ext, ce, c4 + e);
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-20f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c4 + e < hd) pb.store(head, c4 + e, o[e] * inv);
  }
  // peers have read this block's partial; no memory to order
  ptx::cluster_sync_relaxed();
}

// Kernel routes, as the wrappers count them.
enum Route : int { kRouteFMA = 0, kRouteTC = 1 };

// Calls f(std::integral_constant<int, HDP>()) with hd rounded up to 16, 32,
// 64 or 128.
template <class F>
int with_hdp(int hd, F&& f) {
  if (hd < 1 || hd > kMaxHD) return (int)cudaErrorInvalidValue;
  if (hd <= 16) return f(std::integral_constant<int, 16>());
  if (hd <= 32) return f(std::integral_constant<int, 32>());
  if (hd <= 64) return f(std::integral_constant<int, 64>());
  return f(std::integral_constant<int, 128>());
}

// The core's launch shape for `kern` (the core, or a kernel timed at its
// shape): grid (units x head groups, splits), or one cluster when
// `one_cluster`, a cluster of `splits` blocks, the core's shared memory.
// Sets kern's attributes; `attr` must outlive `cfg`.
template <class P, typename TC, int HDP>
int core_config(const void* kern, const P& pb, int splits, cudaStream_t st,
                bool one_cluster, cudaLaunchConfig_t& cfg,
                cudaLaunchAttribute& attr) {
  if (splits < 1 || splits > kMaxSplits || pb.rps % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  const int smem =
      Layout<TC, HDP, block_mtiles<P, TC, HDP>()>::bytes(pb.ext_floats());
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (splits > 8) {  // clusters past the portable 8
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cfg = {};
  cfg.gridDim = dim3(one_cluster ? 1 : pb.units * pb.hgroups, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

// Launch the core, or with max_clusters set report how many clusters of
// `splits` blocks fit on the card at once (cudaOccupancyMaxActiveClusters).
// A launch writes the route of the kernel it launched to *route.
template <class P, typename TC, bool QSPLIT, int HDP>
int launch_core(const P& pb, int splits, cudaStream_t st, int* max_clusters,
                int* route) {
  void* kern = (void*)decode_attn_core<P, TC, QSPLIT, HDP>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = core_config<P, TC, HDP>(kern, pb, splits, st, max_clusters != nullptr,
                                    cfg, attr);
  if (err) return err;
  if (max_clusters)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  if (pb.units * pb.hgroups == 0) return (int)cudaGetLastError();
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attn_core<P, TC, QSPLIT, HDP>, pb);
  if (e != cudaSuccess) return (int)e;
  if (route) *route = sizeof(TC) == 4 ? kRouteFMA : kRouteTC;
  return (int)cudaGetLastError();
}

template <class P, typename TC, bool QSPLIT>
int launch_hd(const P& pb, int splits, cudaStream_t st, int* max_clusters,
              int* route) {
  return with_hdp(pb.hd, [&](auto hdp) {
    return launch_core<P, TC, QSPLIT, decltype(hdp)::value>(
        pb, splits, st, max_clusters, route);
  });
}

__host__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace da
