// Tiled (flash) causal / sliding-window GQA attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (pallas_call in flash_attention, reached through ops.flash_attention_bshd
// on the prompt pass with attn_impl = "chunked"). For every query row it
// computes softmax(q K^T / sqrt(hd) + mask) V over the key rows of its KV
// head, with running (max, sum, acc) carried from key tile to key tile, so
// the (Sq, Sk) score matrix never exists in device memory. The mask is the
// TPU kernel's: an additive, finite -1e30 for cols > rows (causal) and cols
// <= rows - window (sliding window); key tiles that lie wholly past the
// causal frontier or behind the window are skipped. Keeping -1e30 finite
// matters: a row whose first visited tile is wholly masked for it gets
// p = exp(0) = 1 there, and the next live tile's rescale exp(-1e30 - m) = 0
// wipes it out, where -inf would give exp(-inf + inf) = NaN. Columns and
// rows past the ends (Sk, Sq need not be multiples of the tile) are not
// there: a missing column has p = 0 exactly, a missing row is not written.
// Skipping a tile that is wholly masked for a row changes nothing: its
// p are wiped by the rescale once the row meets its own (always live)
// column, so the kernels may skip more finely than the TPU kernel's tiles.
//
// Layout: q and out (B, Sq, H, hd) and k, v (B, Sk, KV, hd) addressed by
// element strides per (batch, position, head) with hd contiguous, so one
// kernel serves the model layout and the reference's flat (BH, S, hd)
// layout (there B = BKV, H = group, KV = 1, and query row bh reads KV row
// bh / group). KV head of query head h: h / (H / KV).
//
// Two routes, chosen by the wrapper from the inputs' dtype:
//
// * bf16 inputs (the serving dtype): flash_attn_tc, on the tensor cores.
//   What bounds it on the H100: at the TinyLlama prompt pass (1 x 256
//   tokens, 32 query heads of 64, 4 KV heads, causal) the live products are
//   ~0.27 GFLOP on ~2.4 MB of bf16: 0.7 us to move the bytes, 0.3 us for
//   the products at the bf16 tensor rate. So it is bytes in principle, and
//   in practice latency: one block per (query head, 64 query rows) is 128
//   blocks, and the last causal tile walks 4 key tiles. The design, in the
//   FlashAttention-2 pattern:
//     - one block of 8 warps per (query head, 64 query rows), the longest
//       causal tiles dispatched first; warp w owns 16 query rows (w % 4)
//       and every other key tile (w / 4: even or odd tiles), so the last
//       tile's chain is 2 key tiles per warp, not 4, and each scheduler has
//       two warps; the two warps of a row group merge their (max, sum,
//       acc) through shared memory at the end, as one softmax over the
//       union (a half that saw only masked columns is rescaled to zero);
//     - q, k and v stay bf16 in shared memory (rows padded by 16 bytes, so
//       ldmatrix reads are free of bank conflicts; hd is zero-padded to
//       16, 32, 64 or 128); the K/V tiles go through a ring of 3 pairs of
//       slots filled with 16-byte cp.async copies, so the next two pairs
//       load while a pair is multiplied (element copies where the rows are
//       not 16-byte aligned): at the prompt pass every key tile a block
//       needs is in flight at once, and the load latency is paid once;
//     - S = Q K^T on mma.sync m16n8k16 bf16 with f32 accumulators, the Q
//       fragments loaded once with ldmatrix, the K fragments by ldmatrix;
//     - the online softmax on the accumulator fragments in registers: each
//       row lives in the 4 lanes of a quad (max by two shuffles, the sum
//       kept per lane and added across the quad once at the end);
//     - O += P V on mma.sync, P taken straight from the S accumulators (the
//       C fragment of S is the A fragment of P), V through ldmatrix.trans.
//   p stays f32 in effect, as in the TPU kernel (flash_attention.py:63-67,
//   an f32 p times v): p is split as p_hi + p_lo, both bf16 (p_hi = bf16(p),
//   p_lo = bf16(p - p_hi), where p - p_hi is exact in f32), and two P V
//   products go into the same f32 accumulator. v is exact in bf16, so the
//   split leaves |p - p_hi - p_lo| <= 2^-16 p, far below the output's own
//   bf16 rounding (2^-8). A single bf16 p would round at 2^-8 and change
//   the function: that rounding is where attention_chunked and this kernel
//   differ.
// * f32 inputs (the f32 smoke configs, the kernel_bench shape):
//   flash_attn_fma, f32 FMAs on the CUDA cores, since a bf16 tensor core
//   would change f32 products. One block of 128 threads per (query head, 64
//   query rows); the query tile, each key tile (both stored transposed,
//   padded rows) and each value tile staged in shared memory; a thread owns
//   4 query rows x 8 key columns of the 64 x 64 score tile and 4 rows x
//   hd/8 columns of the accumulator, the row statistics shared by 8
//   neighbouring lanes (shuffles); p goes through shared memory to P.V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // key rows per tile
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kMaxHD = 128;
constexpr int kTcWarps = 8;         // tc kernel: 4 row groups x 2 key halves
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kPairs = 3;           // key-tile pairs in the tc kernel's ring

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qss, qsh;   // q and o strides (batch, position, head)
  long long ksb, kss, ksh;   // k and v strides
  int H, KV, Sq, Sk, hd, causal, window;
  float scale;
  int vec;                   // tc: every row 16-byte aligned (16-byte copies)
};

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores
// ---------------------------------------------------------------------------

// p as p_hi + p_lo, both bf16, for two neighbouring columns
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = ptx::pack_bf16(p0 - hf.x, p1 - hf.y);
}

// HD: hd rounded up to 16, 32, 64 or 128; LD = HD + 8 the row stride of the
// shared tiles in elements.
template <int HD>
__global__ void __launch_bounds__(kTcThreads) flash_attn_tc(Args a) {
  constexpr int LD = HD + 8;
  constexpr int KS = HD / 16;   // k-steps of S = Q K^T over hd
  constexpr int NS = kBK / 8;   // n-tiles of S over the key tile
  constexpr int ND = HD / 8;    // n-tiles of O over hd
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                       // [2 kPairs][kBK][LD]
  bf16* Vs = Ks + 2 * kPairs * kBK * LD;          // [2 kPairs][kBK][LD]

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int hd = a.hd, Sq = a.Sq, Sk = a.Sk;
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * kBQ;  // longest tiles first
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.ksb + kvh * a.ksh;
  bf16* o = static_cast<bf16*>(a.o) + b * a.qsb + h * a.qsh;

  // pad columns hd .. HD-1 are read by the products and never copied: zero
  // them once in every tile
  if (hd < HD) {
    const int padw = HD - hd;
    for (int i = t; i < (kBQ + 4 * kPairs * kBK) * padw; i += kTcThreads)
      Qs[(i / padw) * LD + hd + i % padw] = __float2bfloat16_rn(0.f);
  }
  // one 64-row tile: rows past `rows` are zero-filled
  auto load_tile = [&](bf16* dst, const bf16* src, long long stride, int r0,
                       int rows) {
    if (a.vec) {
      constexpr int CPR = HD / 8;  // 16-byte copies per padded row
#pragma unroll
      for (int i = t; i < kBK * CPR; i += kTcThreads) {
        const int r = i / CPR, c = (i % CPR) * 8;
        const bool ok = r0 + r < rows;
        if (c < hd)
          ptx::cp_async16(dst + r * LD + c,
                          src + (ok ? (long long)(r0 + r) * stride + c : 0),
                          ok);
      }
    } else {
      for (int i = t; i < kBK * hd; i += kTcThreads) {
        const int r = i / hd, c = i % hd;
        dst[r * LD + c] = r0 + r < rows ? src[(long long)(r0 + r) * stride + c]
                                        : __float2bfloat16_rn(0.f);
      }
    }
  };

  // key tiles to visit: none wholly past the causal frontier or wholly
  // behind the window of this block's rows
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (a.window > 0)
    while (kt_begin < kt_end &&
           min(kt_begin * kBK + kBK, Sk) - 1 <= q0 - a.window)
      ++kt_begin;

  // the ring holds kPairs pairs of key tiles; pair p (tiles kt_begin + 2p
  // and + 2p + 1) goes to slots 2 (p % kPairs) and + 1. Pairs 0 ..
  // kPairs - 2 are in flight at once, q with the first.
  auto load_pair = [&](int p) {
    const int slot = 2 * (p % kPairs);
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int kt = kt_begin + 2 * p + u;
      if (kt < kt_end) {
        load_tile(Ks + (slot + u) * kBK * LD, k, a.kss, kt * kBK, Sk);
        load_tile(Vs + (slot + u) * kBK * LD, v, a.kss, kt * kBK, Sk);
      }
    }
  };
  load_tile(Qs, q, a.qss, q0, Sq);
  const int npairs = (kt_end - kt_begin + 1) / 2;
#pragma unroll 1
  for (int p = 0; p < kPairs - 1; ++p) {
    if (p < npairs) load_pair(p);
    ptx::cp_async_commit();
  }

  // warp: 16 query rows (row group rg) and every other key tile (half)
  const int rg = warp % 4, half = warp / 4;
  const int wq0 = q0 + 16 * rg;                // this warp's first row
  const int w_last = min(wq0 + 15, Sq - 1);    // and last (< wq0: no rows)
  const int r0 = wq0 + g, r1 = wq0 + g + 8;    // the two rows of this lane
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int p = 0; p < npairs; ++p) {
    ptx::cp_async_wait<kPairs - 2>();
    __syncthreads();  // pair p visible to all; pair p-1 consumed by all
    if (p + kPairs - 1 < npairs) load_pair(p + kPairs - 1);
    ptx::cp_async_commit();
    if (p == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ptx::ldmatrix_x4(qf[ks], Qs + (16 * rg + lane % 16) * LD + ks * 16 +
                                     (lane / 16) * 8);
    }
    const int kt = kt_begin + 2 * p + half, buf = 2 * (p % kPairs) + half;
    const int k0 = kt * kBK;
    const bool live =
        kt < kt_end && wq0 <= w_last && !(a.causal && k0 > w_last) &&
        !(a.window > 0 && min(k0 + kBK, Sk) - 1 <= wq0 - a.window);
    if (!live) continue;
    const bf16* Kb = Ks + buf * kBK * LD;
    const bf16* Vb = Vs + buf * kBK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];  // b0, b1 of key n-tiles j and j+1
        ptx::ldmatrix_x4(kf, Kb + (8 * j + lane % 8 + (lane / 16) * 8) * LD +
                                 ks * 16 + ((lane / 8) % 2) * 8);
        ptx::mma_bf16(s[j], qf[ks], kf[0], kf[1]);
        ptx::mma_bf16(s[j + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, mask, online softmax; lane holds rows r0 (e < 2), r1 (e >= 2)
    const bool need_mask = (a.causal && k0 + kBK - 1 > wq0) ||
                           (a.window > 0 && k0 <= w_last - a.window) ||
                           k0 + kBK > Sk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (need_mask) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          // one -1e30 however many conditions mask the column, as the TPU
          // kernel's where() chain builds it
          if ((a.causal && col > row) ||
              (a.window > 0 && col <= row - a.window))
            x += kNegInf;
          if (col >= Sk) x = -INFINITY;  // not there: p = 0 exactly
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V, P = p_hi + p_lo straight from the S fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t vf[4];  // b0, b1 of hd n-tiles d and d+1
        ptx::ldmatrix_x4_trans(
            vf, Vb + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * LD + 8 * d +
                    (lane / 16) * 8);
        ptx::mma_bf16(acc[d], ph, vf[0], vf[1]);
        ptx::mma_bf16(acc[d], pl, vf[0], vf[1]);
        ptx::mma_bf16(acc[d + 1], ph, vf[2], vf[3]);
        ptx::mma_bf16(acc[d + 1], pl, vf[2], vf[3]);
      }
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the exchange below

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // the two key halves of a row group merge through shared memory, each
  // finishing half of the columns: it hands the other half its (m, l) and
  // the sums of the other's columns, and rescales both to the larger max
  constexpr int NH = ND / 2, XS = (4 + 4 * NH) * 32;
  float* mine = reinterpret_cast<float*>(smem_raw) + (2 * rg + half) * XS;
  const float* theirs =
      reinterpret_cast<const float*>(smem_raw) + (2 * rg + (half ^ 1)) * XS;
  mine[lane] = m[0];
  mine[32 + lane] = m[1];
  mine[64 + lane] = l[0];
  mine[96 + lane] = l[1];
#pragma unroll
  for (int dd = 0; dd < NH; ++dd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mine[(4 + 4 * dd + e) * 32 + lane] = half ? acc[dd][e] : acc[NH + dd][e];
  __syncthreads();
  float s0[2], s1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = theirs[32 * i + lane], l1 = theirs[64 + 32 * i + lane];
    const float mx = fmaxf(m[i], m1);
    s0[i] = __expf(m[i] - mx);
    s1[i] = __expf(m1 - mx);
    l[i] = 1.f / fmaxf(l[i] * s0[i] + l1 * s1[i], 1e-20f);
  }
#pragma unroll
  for (int dd = 0; dd < NH; ++dd) {
    const int col = 8 * (half * NH + dd) + 2 * tq;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = ((half ? acc[NH + dd][e] : acc[dd][e]) * s0[e >> 1] +
              theirs[(4 + 4 * dd + e) * 32 + lane] * s1[e >> 1]) *
             l[e >> 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? r1 : r0;
      if (row >= Sq || col >= hd) continue;
      bf16* dst = o + (long long)row * a.qss + col;
      if (a.vec) {  // col + 1 < hd and 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      } else {
        dst[0] = __float2bfloat16_rn(v[2 * i]);
        if (col + 1 < hd) dst[1] = __float2bfloat16_rn(v[2 * i + 1]);
      }
    }
  }
}

template <int HD>
int launch_tc_hd(const Args& a, int B, cudaStream_t st) {
  const int smem =
      (kBQ + 4 * kPairs * kBK) * (HD + 8) * (int)sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * a.H, (a.Sq + kBQ - 1) / kBQ);
  flash_attn_tc<HD><<<grid, kTcThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 inputs: f32 FMAs
// ---------------------------------------------------------------------------

constexpr int kTP = kBK + 1;        // padded row of the transposed q / k tiles
constexpr int kPP = kBK + 2;        // padded row of the probabilities
constexpr int kU = 8;               // loads in flight per thread when staging

__host__ __device__ constexpr int fma_smem_floats(int hd) {
  // Qt [hd][kTP], Kt [hd][kTP], Vs [kBK][hd], Ps [kBQ][kPP]
  return 2 * hd * kTP + kBK * hd + kBQ * kPP;
}

// HD: hd rounded up to a multiple of 8 (the accumulator's columns).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_fma(Args a) {
  extern __shared__ float sm[];
  const int hd = a.hd;
  float* Qt = sm;                  // Qt[d][r] = q[q0 + r][d]
  float* Kt = Qt + hd * kTP;       // Kt[d][c] = k[k0 + c][d]
  float* Vs = Kt + hd * kTP;       // Vs[c][d] = v[k0 + c][d]
  float* Ps = Vs + kBK * hd;       // Ps[r][c] = p of row r, column c

  const int t = threadIdx.x;
  const int rg = t / 8, cg = t % 8;  // rows 4 rg .. 4 rg + 3; cols cg + 8 j
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const float* __restrict__ q = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* __restrict__ k = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* __restrict__ v = static_cast<const float*>(a.v) + b * a.ksb + kvh * a.ksh;
  float* o = static_cast<float*>(a.o) + b * a.qsb + h * a.qsh;

  // staging: kU independent loads per thread are issued before their
  // stores, so a tile costs a few memory latencies, not one per element
  for (int base = 0; base < kBQ * hd; base += kU * kThreads) {
    float x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads + t, r = i / hd, d = i % hd;
      x[u] = i < kBQ * hd && q0 + r < a.Sq ? q[(q0 + r) * a.qss + d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads + t;
      if (i < kBQ * hd) Qt[(i % hd) * kTP + i / hd] = x[u];
    }
  }

  constexpr int ND = HD / 8;  // accumulator columns per thread
  float acc[4][ND], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  for (int k0 = 0; k0 < a.Sk; k0 += kBK) {
    const int k_last = min(k0 + kBK, a.Sk) - 1;
    // tile-level gating, as the TPU kernel: skip wholly masked key tiles
    if (a.causal && k0 > q_last) break;
    if (a.window > 0 && k_last <= q0 - a.window) continue;

    __syncthreads();  // the previous tile's Kt, Vs and Ps reads are done
    for (int base = 0; base < kBK * hd; base += kU * kThreads) {
      float kx[kU], vx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * kThreads + t, c = i / hd, d = i % hd;
        const bool in = i < kBK * hd && k0 + c < a.Sk;
        const long long off = (long long)(k0 + c) * a.kss + d;
        kx[u] = in ? k[off] : 0.f;
        vx[u] = in ? v[off] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * kThreads + t;
        if (i < kBK * hd) {
          Kt[(i % hd) * kTP + i / hd] = kx[u];
          Vs[i] = vx[u];
        }
      }
    }
    __syncthreads();

    // scores for rows 4 rg + i, columns cg + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * kTP + 4 * rg + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Kt[d * kTP + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; the 8 lanes of a row group hold one row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] * a.scale;
        if ((a.causal && col > row) || (a.window > 0 && col <= row - a.window))
          x += kNegInf;
        if (col >= a.Sk) x = -INFINITY;  // not there: p = 0 exactly
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * rg + i) * kPP + cg + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[rows][d] += P V, columns d = cg + 8 j
    const int nc = k_last - k0 + 1;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      float pv[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * rg + i) * kPP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = cg + 8 * j;
        vv[j] = d < hd ? Vs[c * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = cg + 8 * j;
      if (d < hd) o[row * a.qss + d] = acc[i][j] * inv;
    }
  }
}

template <int HD>
int launch_fma_hd(const Args& a, int B, cudaStream_t st) {
  auto kern = flash_attn_fma<HD>;
  const size_t smem = (size_t)fma_smem_floats(a.hd) * sizeof(float);
  // The limit is per device, so it is raised on every launch (a cheap
  // call) to the largest hd of this instantiation.
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(fma_smem_floats(HD) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.H);
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int check(int B, int H, int KV, int hd) {
  if (hd < 1 || hd > kMaxHD || KV < 1 || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q, out: (B, Sq, H, hd) at element strides (qsb, qss, qsh); k, v:
// (B, Sk, KV, hd) at (ksb, kss, ksh); hd contiguous everywhere. H a
// multiple of KV, 1 <= hd <= 128, window 0 for none. Launch on `stream` and
// return cudaGetLastError().
//
// bf16 q, k, v and out: the tensor-core kernel.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int Sq, int Sk, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, int causal,
    int window, float scale, void* stream) {
  if (const int e = check(B, H, KV, hd)) return e;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  // 16-byte copies (and paired output stores) need every row start
  // 16-byte aligned
  const int vec = hd % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(out) && qsb % 8 == 0 &&
                  qss % 8 == 0 && qsh % 8 == 0 && ksb % 8 == 0 &&
                  kss % 8 == 0 && ksh % 8 == 0;
  Args a{q, k, v, out, qsb, qss, qsh, ksb, kss, ksh,
         H, KV, Sq, Sk, hd, causal, window, scale, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 16) return launch_tc_hd<16>(a, B, st);
  if (hd <= 32) return launch_tc_hd<32>(a, B, st);
  if (hd <= 64) return launch_tc_hd<64>(a, B, st);
  return launch_tc_hd<kMaxHD>(a, B, st);
}

// f32 q, k, v and out: the FMA kernel.
extern "C" int flash_attention_fma_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int Sq, int Sk, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, int causal,
    int window, float scale, void* stream) {
  if (const int e = check(B, H, KV, hd)) return e;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  Args a{q, k, v, out, qsb, qss, qsh, ksb, kss, ksh,
         H, KV, Sq, Sk, hd, causal, window, scale, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch_fma_hd<32>(a, B, st);
  if (hd <= 64) return launch_fma_hd<64>(a, B, st);
  return launch_fma_hd<kMaxHD>(a, B, st);
}
