// Width-gated skinny matrix product shared by morph_matmul.cu,
// fused_decode.cu and fused_verify.cu: out[r, n] = sum_k x[r, k] * w[k, n]
// for rows r of a (B*M, K) activation and a (K, N) row-major weight, with
// per-batch gates
//   * columns n >= active_n[b] come out as exact zeros,
//   * contraction rows k >= active_k[b] contribute nothing,
// where b = r / M. Sums are f32.
//
// Replaces the TPU kernel src/repro/kernels/morph_matmul.py:_kernel. What
// bounds it on the H100: the bytes of the weight. The rows are few (R = B*M
// = 8 at decode, 40 at the verify pass), so each weight element feeds 2R
// flops, and the f32 master weights (4 B a element) take 3.35 TB/s to
// stream. The TPU grid walks (B, M/bm, N/bn, K/bk) and streams the weight
// once per batch row. Here:
//   * a block owns a 64-column tile of the output for ALL rows (up to 128
//     rows in registers at once, rows past that in further passes): each
//     weight chunk is staged in shared memory once and consumed by every
//     row, so each weight byte is read from device memory once per launch;
//   * a ring of kStages = 3 chunks of 64 contraction rows, each filled by
//     16-byte cp.async copies with zero fill (element copies where rows are
//     not 16-byte aligned), keeps two chunks of weight loads in flight
//     while the third is multiplied, with 3 blocks on an SM; the chunk's x
//     rows are staged beside it, once for all rows;
//   * each of the 4 warps owns 16 of the tile's columns for all rows;
//   * rounding mode (bf16 x, weights cast to bf16 as the plain version's
//     w.to(x.dtype), or bf16 weights): tensor cores, mma.sync m16n8k16 bf16
//     with f32 accumulators, operands swapped so that out^T = w^T x^T: the
//     16 columns are the MMA's M side and the rows its n8 side, so 8 rows
//     fill one n8 tile and 40 rows five (the B fragments of two n8 tiles
//     come from one ldmatrix). f32 weights are rounded to nearest even
//     (__floats2bfloat162_rn) as the A fragments are built. The product is
//     then exactly the TPU kernel's jnp.dot of bf16 operands with f32 sums;
//   * exact-f32 mode (f32 x, or f32 weights without rounding: the fused
//     kernels' projections): f32 FMAs, since a tensor core would change
//     f32 x f32 products. A lane owns 4 columns x the rows 8 j + g.
// A 2048-column weight has only 32 tiles, too few to keep 132 SMs reading,
// so the contraction is also split across blocks (grid.y, up to 16). The
// splits of a tile are launched as one thread block cluster: each keeps its
// f32 partial in its own shared memory, and after a cluster barrier each
// block adds every splits-th group of 4 elements of the tile over all the
// splits' partials, read through distributed shared memory, in split
// order -- deterministic, one launch, no workspace in device memory, no
// atomics. The caller's plan takes the most splits whose clusters all fit
// on the card at once (gemv_max_clusters): a grid that overflows its block
// slots runs a second wave.
// The gates are read from device memory by every block (never a host round
// trip): a column tile at or past max_b active_n reads no weights and
// writes zeros, contraction rows at or past max_b active_k are neither
// copied nor multiplied, and narrower rows inside a live tile are masked
// per row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace rt {

constexpr int kThreads = 128;             // 4 warps
constexpr int kBN = 16 * (kThreads / 32); // 64 output columns per block
constexpr int kKC = 64;                   // contraction rows per chunk
constexpr int kStages = 3;                // chunks in the cp.async ring
constexpr int kMaxSeg = 3;
constexpr int kMaxSplits = 16;            // contraction splits: one cluster
constexpr int kMinBlocks = 3;             // resident blocks per SM (registers)
constexpr int kSmemTail = 16 + 4 * 128;   // s_lim and s_ncol after the ring

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Row strides of the staged tiles, in elements: 16 bytes of padding keep
// every row 16-byte aligned and put neighbouring rows 4 banks apart.
template <typename T>
__host__ __device__ constexpr int pad_of() { return 16 / (int)sizeof(T); }
template <typename TW>
__host__ __device__ constexpr int ldw() { return kBN + pad_of<TW>(); }
template <typename TX>
__host__ __device__ constexpr int ldx() { return kKC + pad_of<TX>(); }
template <typename TX, typename TW>
__host__ __device__ constexpr int stage_bytes(int rows) {
  return kKC * ldw<TW>() * (int)sizeof(TW) + rows * ldx<TX>() * (int)sizeof(TX);
}

struct Seg {
  const void* w;   // (K, N) row-major
  void* out;       // (B*M, N) row-major
  const int* an;   // (B,) live columns per batch row, or null (all N)
  int N;
  int tiles;       // ceil(N / kBN), set by gemv_launch
};

struct GemvArgs {
  const void* x;   // (B*M, K) row-major
  const int* ak;   // (B,) live contraction rows per batch row, or null (all K)
  int B, M, K;
  int nseg;        // 1..kMaxSeg products sharing x; blocks walk their tiles in order
  Seg seg[kMaxSeg];
  int splits;      // contraction splits per tile: grid.y and cluster size
  int k_per_split; // contraction rows per split, a multiple of kKC
  int out_dt;      // kF32 or kBF16, every segment; set by gemv_launch
  int vec_w, vec_x;  // 16-byte copies allowed; set by gemv_launch
};

__device__ __forceinline__ void store_out(void* out, int dt, size_t i,
                                          float v) {
  if (dt == kF32) static_cast<float*>(out)[i] = v;
  else static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// bf16 pair (k, k+1) with each half zeroed where its k is at or past lim
__device__ __forceinline__ uint32_t mask_pair(uint32_t v, int k, int lim) {
  return v & ((k < lim ? 0x0000ffffu : 0u) | (k + 1 < lim ? 0xffff0000u : 0u));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lds2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Exact-f32 products of one staged chunk: lane owns columns wc + 4 tq ..
// +3 and rows 8 j + g, the contraction walked in ascending pairs. MASK
// zeroes x past each row's live contraction rows kr (only the chunk that
// crosses a row's limit needs it).
template <bool MASK, int NT, typename TX, typename TW>
__device__ __forceinline__ void fma_chunk(float (&acc)[NT][4], const TW* wsm,
                                          const TX* xsm, int nt, int k0,
                                          const int (&kr)[NT], int wc, int g,
                                          int tq) {
  constexpr int LDW = ldw<TW>(), LDX = ldx<TX>();
#pragma unroll 4
  for (int kk = 0; kk < kKC; kk += 2) {
    const float4 w0 = lds4(wsm + kk * LDW + wc + 4 * tq);
    const float4 w1 = lds4(wsm + (kk + 1) * LDW + wc + 4 * tq);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        float2 xv = lds2(xsm + (8 * j + g) * LDX + kk);
        if (MASK) {
          if (k0 + kk >= kr[j]) xv.x = 0.f;
          if (k0 + kk + 1 >= kr[j]) xv.y = 0.f;
        }
        acc[j][0] = fmaf(xv.y, w1.x, fmaf(xv.x, w0.x, acc[j][0]));
        acc[j][1] = fmaf(xv.y, w1.y, fmaf(xv.x, w0.y, acc[j][1]));
        acc[j][2] = fmaf(xv.y, w1.z, fmaf(xv.x, w0.z, acc[j][2]));
        acc[j][3] = fmaf(xv.y, w1.w, fmaf(xv.x, w0.w, acc[j][3]));
      }
    }
  }
}

// Tensor-core products of one staged chunk (rounding mode): per 16
// contraction rows, the A fragment of w^T (this warp's 16 columns, f32
// weights rounded to bf16 as it is built) and, per pair of n8 row tiles,
// one ldmatrix of x^T. MASK zeroes x past each row's live contraction rows
// kr (only the chunk that crosses a row's limit needs it).
template <bool MASK, int NT, typename TW>
__device__ __forceinline__ void tc_chunk(float (&acc)[NT][4], const TW* wsm,
                                         const __nv_bfloat16* xsm, int nt,
                                         int k0, const int (&kr)[NT], int wc,
                                         int lane) {
  constexpr int LDW = ldw<TW>(), LDX = ldx<__nv_bfloat16>();
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int ks = 0; ks < kKC / 16; ++ks) {
    uint32_t af[4];
    if constexpr (sizeof(TW) == 4) {
      const float* wp = reinterpret_cast<const float*>(wsm) +
                        (16 * ks + 2 * tq) * LDW + wc + g;
      af[0] = ptx::pack_bf16(wp[0], wp[LDW]);
      af[1] = ptx::pack_bf16(wp[8], wp[LDW + 8]);
      af[2] = ptx::pack_bf16(wp[8 * LDW], wp[9 * LDW]);
      af[3] = ptx::pack_bf16(wp[8 * LDW + 8], wp[9 * LDW + 8]);
    } else {
      const int i = lane / 8;
      ptx::ldmatrix_x4_trans(
          af, wsm + (16 * ks + (i >> 1) * 8 + lane % 8) * LDW + wc +
                  (i & 1) * 8);
    }
    const int kk = k0 + 16 * ks + 2 * tq;  // contraction row of b0's low half
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      // b0, b1 of row tiles j and j + 1 (x2: tile j alone)
      uint32_t bf[4];
      const __nv_bfloat16* xp =
          xsm + (8 * j + lane % 8) * LDX + 16 * ks + ((lane / 8) % 2) * 8;
      const bool two = j + 1 < NT && j + 1 < nt;
      if (two) ptx::ldmatrix_x4(bf, xp + (lane / 16) * 8 * LDX);
      else ptx::ldmatrix_x2(bf, xp);
      if (MASK) {
        bf[0] = mask_pair(bf[0], kk, kr[j]);
        bf[1] = mask_pair(bf[1], kk + 8, kr[j]);
      }
      ptx::mma_bf16(acc[j], af, bf[0], bf[1]);
      if constexpr (NT > 1) {
        if (two) {
          if (MASK) {
            bf[2] = mask_pair(bf[2], kk, kr[j + 1]);
            bf[3] = mask_pair(bf[3], kk + 8, kr[j + 1]);
          }
          ptx::mma_bf16(acc[j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
}

// Launched in clusters of (1, splits, 1): the splits of one column tile
// run together, and the split-K sum goes through distributed shared memory.
// TC: tensor cores on bf16 x (rounding mode); else exact f32 FMAs.
// NT: n8 row tiles held at once (rows per pass 8 NT).
template <typename TX, typename TW, bool TC, int NT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gated_gemm(GemvArgs a) {
  constexpr int LDW = ldw<TW>(), LDX = ldx<TX>();
  constexpr int W_BYTES = kKC * LDW * (int)sizeof(TW);
  extern __shared__ __align__(16) unsigned char smem[];

  // segment of this tile; constant indices keep the arguments in param space
  int tile = blockIdx.x, col0 = 0;
  const void* wv_ = a.seg[0].w;
  void* outv = a.seg[0].out;
  const int* an = a.seg[0].an;
  int N = a.seg[0].N;
  if (a.nseg > 1 && tile >= a.seg[0].tiles) {
    tile -= a.seg[0].tiles;
    col0 += a.seg[0].N;
    wv_ = a.seg[1].w; outv = a.seg[1].out; an = a.seg[1].an; N = a.seg[1].N;
    if (a.nseg > 2 && tile >= a.seg[1].tiles) {
      tile -= a.seg[1].tiles;
      col0 += a.seg[1].N;
      wv_ = a.seg[2].w; outv = a.seg[2].out; an = a.seg[2].an; N = a.seg[2].N;
    }
  }
  const TW* w = static_cast<const TW*>(wv_);
  const TX* x = static_cast<const TX*>(a.x);
  const int B = a.B, M = a.M, K = a.K, R = B * M;
  const int n0 = tile * kBN;
  const int split = (int)blockIdx.y, splits = a.splits;
  const int t = threadIdx.x, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int wc = 16 * (t / 32);  // this warp's 16 columns of the tile
  // ring slot: the weight chunk and the staged x rows of this launch
  const int stage = W_BYTES + 8 * min(NT, (R + 7) / 8) * LDX * (int)sizeof(TX);
  int* s_lim = reinterpret_cast<int*>(smem + kStages * stage);
  int* s_ncol = s_lim + 4;  // live columns of each row of the pass

  // the raw active_k of this lane's rows in the first pass, fetched in the
  // same round trip as the gates
  int kraw[NT];
  auto fetch_kraw = [&](int rb) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = rb + 8 * j + g;
      kraw[j] = row < R ? (a.ak ? a.ak[row / M] : K) : 0;
    }
  };
  fetch_kraw(0);
  auto fetch_ncol = [&](int rb) {
    if (t < 8 * NT && rb + t < R) s_ncol[t] = an ? an[(rb + t) / M] : N;
  };
  fetch_ncol(0);
  if (t < 32) {  // widest live extents over the batch: one warp, loads in parallel
    int mn = 0, mk = 0;
    for (int b = t; b < B; b += 32) {
      mn = max(mn, an ? min(an[b], N) : N);
      mk = max(mk, a.ak ? min(a.ak[b], K) : K);
    }
    for (int o = 16; o > 0; o >>= 1) {
      mn = max(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mk = max(mk, __shfl_xor_sync(0xffffffffu, mk, o));
    }
    if (t == 0) {
      s_lim[0] = mn;
      s_lim[1] = mk;
    }
  }
  __syncthreads();
  const int maxN = s_lim[0], maxK = s_lim[1];

  if (n0 >= maxN) {  // the whole tile is gated off: zeros, no weight bytes
    if (split == 0) {
      for (int i = t; i < R * kBN; i += kThreads) {
        const int r = i / kBN, n = n0 + i % kBN;
        if (n < N) store_out(outv, a.out_dt, (size_t)r * N + n, 0.f);
      }
    }
    return;  // every block of the cluster returns here: no cluster barrier
  }

  const int kb = split * a.k_per_split;
  const int ke = min(maxK, kb + a.k_per_split);  // <= kb: a zero partial
  const int nlive = min(N, maxN);                // columns worth reading
  const int nchunks = ke > kb ? (ke - kb + kKC - 1) / kKC : 0;

  for (int rb = 0; rb < R; rb += 8 * NT) {
    const int nr = min(8 * NT, R - rb), nt = (nr + 7) / 8;
    if (rb > 0) {
      __syncthreads();  // the last pass's stores have read s_ncol
      fetch_kraw(rb);
      fetch_ncol(rb);
    }
    int kr[NT], kr_min = ke;  // live contraction rows of this lane's rows
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      kr[j] = min(kraw[j], ke);
      if (j < nt) kr_min = min(kr_min, kr[j]);
    }
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    // stage chunk c (contraction rows kb + 64 c ..) into ring slot s: the
    // weight rows past ke and columns past nlive, and the x rows past nr
    // or contraction rows past ke, are zero-filled without being read
    auto load = [&](int c, int s) {
      const int k0 = kb + c * kKC;
      TW* wsm = reinterpret_cast<TW*>(smem + s * stage);
      TX* xsm = reinterpret_cast<TX*>(smem + s * stage + W_BYTES);
      if (a.vec_w) {
        // thread t copies columns cc .. of rows r0, r0 + RS, ...
        constexpr int CW = 16 / (int)sizeof(TW), PER = kBN / CW;
        constexpr int RS = kThreads / PER;
        const int r0 = t / PER, cc = (t % PER) * CW;
        const bool col_ok = n0 + cc < nlive;
        const TW* src = w + (size_t)(k0 + r0) * N + n0 + cc;
#pragma unroll
        for (int u = 0; u < kKC / RS; ++u) {
          const bool ok = col_ok && k0 + r0 + u * RS < ke;
          ptx::cp_async16(wsm + (r0 + u * RS) * LDW + cc,
                          ok ? src + (size_t)u * RS * N : w, ok);
        }
      } else {
        for (int i = t; i < kKC * kBN; i += kThreads) {
          const int r = i / kBN, cc = i % kBN, k = k0 + r, n = n0 + cc;
          wsm[r * LDW + cc] =
              k < ke && n < nlive ? w[(size_t)k * N + n] : zero<TW>();
        }
      }
      if (a.vec_x) {
        constexpr int CX = 16 / (int)sizeof(TX), PER = kKC / CX;
        for (int i = t; i < 8 * nt * PER; i += kThreads) {
          const int r = i / PER, kk = (i % PER) * CX, k = k0 + kk;
          const bool ok = r < nr && k < ke;
          ptx::cp_async16(xsm + r * LDX + kk,
                          ok ? x + (size_t)(rb + r) * K + k : x, ok);
        }
      } else {
        for (int i = t; i < 8 * nt * kKC; i += kThreads) {
          const int r = i / kKC, kk = i % kKC, k = k0 + kk;
          xsm[r * LDX + kk] =
              r < nr && k < ke ? x[(size_t)(rb + r) * K + k] : zero<TX>();
        }
      }
    };

#pragma unroll 1
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nchunks) load(s, s);
      ptx::cp_async_commit();
    }
#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      ptx::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c landed for all; chunk c-1's slot consumed
      if (c + kStages - 1 < nchunks)
        load(c + kStages - 1, (c + kStages - 1) % kStages);
      ptx::cp_async_commit();

      const int s = c % kStages, k0 = kb + c * kKC;
      const TW* wsm = reinterpret_cast<const TW*>(smem + s * stage);
      const TX* xsm = reinterpret_cast<const TX*>(smem + s * stage + W_BYTES);
      if constexpr (TC) {
        // ldmatrix and mma are warp-wide: the whole warp takes one branch
        if (__any_sync(0xffffffffu, k0 + kKC > kr_min))
          tc_chunk<true>(acc, wsm, xsm, nt, k0, kr, wc, lane);
        else
          tc_chunk<false>(acc, wsm, xsm, nt, k0, kr, wc, lane);
      } else if (k0 + kKC > kr_min) {
        fma_chunk<true>(acc, wsm, xsm, nt, k0, kr, wc, g, tq);
      } else {
        fma_chunk<false>(acc, wsm, xsm, nt, k0, kr, wc, g, tq);
      }
    }
    ptx::cp_async_wait<0>();
    __syncthreads();  // the ring is free: partial sums may take its place

    // this lane's sums: acc[j][e] is (row 8 j + rr, column cc of the tile)
    float* red = reinterpret_cast<float*>(smem);  // [8 nt][kBN] partials
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int rr, cc;
        if constexpr (TC) {  // D = out^T: m = column, n = row
          rr = 2 * tq + (e & 1);
          cc = wc + g + 8 * (e >> 1);
        } else {
          rr = g;
          cc = wc + 4 * tq + e;
        }
        const int r = 8 * j + rr, n = n0 + cc;
        if (j >= nt) continue;
        if (splits > 1) {
          red[r * kBN + cc] = acc[j][e];
        } else if (r < nr && n < N) {
          store_out(outv, a.out_dt, (size_t)(rb + r) * N + n,
                    n < s_ncol[r] ? acc[j][e] : 0.f);
        }
      }
    }
    if (splits == 1) continue;
    // the splits of this tile add their partials in split order, each
    // block taking every splits-th group of 4 elements of the tile (one
    // 16-byte load from each split, all in flight before the sums)
    ptx::cluster_sync();
    const int groups = nr * kBN / 4;
    for (int q = split * kThreads + t; q < groups; q += splits * kThreads) {
      float4 part[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        part[s] = s < splits ? ptx::ld_cluster_f32x4(red + 4 * q, s)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        v[0] += part[s].x;
        v[1] += part[s].y;
        v[2] += part[s].z;
        v[3] += part[s].w;
      }
      const int r = 4 * q / kBN, c = 4 * q % kBN;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + c + e;
        if (n < N)
          store_out(outv, a.out_dt, (size_t)(rb + r) * N + n,
                    n < s_ncol[r] ? v[e] : 0.f);
      }
    }
    ptx::cluster_sync();  // peers have read this block's partials
  }
}

// Launch (max_clusters null) or report how many clusters of grid.y blocks
// of this kernel fit on the card at once (cudaOccupancyMaxActiveClusters).
template <typename TX, typename TW, bool TC, int NT>
static int launch_nt(const GemvArgs& a, dim3 grid, cudaStream_t st,
                     int* max_clusters) {
  const int R = a.B * a.M;
  const int nt = R < 8 * NT ? (R + 7) / 8 : NT;
  const int smem = kStages * (stage_bytes<TX, TW>(8 * nt)) + kSmemTail;
  auto kern = gated_gemm<TX, TW, TC, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (grid.y > 8) {  // clusters past the portable 8 (the H100 takes 16)
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// rows held at once: 8, 16, 24, 32, 40 (the verify pass), 64 or 128 (more
// rows take further passes)
template <typename TX, typename TW, bool TC>
static int launch_rows(const GemvArgs& a, dim3 grid, cudaStream_t st,
                       int* max_clusters) {
  const int R = a.B * a.M;
  if (R <= 8) return launch_nt<TX, TW, TC, 1>(a, grid, st, max_clusters);
  if (R <= 16) return launch_nt<TX, TW, TC, 2>(a, grid, st, max_clusters);
  if (R <= 24) return launch_nt<TX, TW, TC, 3>(a, grid, st, max_clusters);
  if (R <= 32) return launch_nt<TX, TW, TC, 4>(a, grid, st, max_clusters);
  if (R <= 40) return launch_nt<TX, TW, TC, 5>(a, grid, st, max_clusters);
  if (R <= 64) return launch_nt<TX, TW, TC, 8>(a, grid, st, max_clusters);
  return launch_nt<TX, TW, TC, 16>(a, grid, st, max_clusters);
}

// The kernel for the dtypes: rounding mode (bf16 x with round_w, or bf16 x
// with bf16 weights) on the tensor cores, everything else in exact f32.
// ALLOW_TC false compiles the exact-f32 kernels only.
template <bool ALLOW_TC>
static int dispatch(const GemvArgs& a, dim3 grid, int x_dt, int w_dt,
                    bool round_w, cudaStream_t st, int* max_clusters) {
  typedef __nv_bfloat16 bf16;
  if constexpr (ALLOW_TC) {
    if (x_dt == kBF16 && (round_w || w_dt == kBF16)) {
      if (w_dt == kF32)
        return launch_rows<bf16, float, true>(a, grid, st, max_clusters);
      return launch_rows<bf16, bf16, true>(a, grid, st, max_clusters);
    }
  }
  if (x_dt == kF32) {
    if (w_dt == kF32)
      return launch_rows<float, float, false>(a, grid, st, max_clusters);
    return launch_rows<float, bf16, false>(a, grid, st, max_clusters);
  }
  if (w_dt == kF32)
    return launch_rows<bf16, float, false>(a, grid, st, max_clusters);
  return launch_rows<bf16, bf16, false>(a, grid, st, max_clusters);
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch over a.nseg products that share x. dtype codes: 0 f32, 1 bf16.
// ALLOW_TC false compiles the exact-f32 kernels only (the fused kernels'
// projections). a.splits / k_per_split come from the caller's plan
// (kernels/morph_matmul.py: plan): 1 <= splits <= kMaxSplits (one cluster),
// k_per_split a multiple of kKC. Returns the launch's error code.
template <bool ALLOW_TC = true>
static int gemv_launch(GemvArgs a, int x_dt, int w_dt, int out_dt,
                       bool round_w, cudaStream_t st) {
  int blocks = 0;
  a.out_dt = out_dt;
  const int wsize = w_dt == kF32 ? 4 : 2, xsize = x_dt == kF32 ? 4 : 2;
  a.vec_w = 1;
  for (int i = 0; i < a.nseg; ++i) {
    a.seg[i].tiles = (a.seg[i].N + kBN - 1) / kBN;
    blocks += a.seg[i].tiles;
    a.vec_w &= aligned16(a.seg[i].w) && (a.seg[i].N * wsize) % 16 == 0;
  }
  a.vec_x = aligned16(a.x) && (a.K * xsize) % 16 == 0;
  if (blocks == 0 || a.B * a.M == 0) return (int)cudaGetLastError();
  if (a.k_per_split % kKC != 0 || a.splits < 1 || a.splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  return dispatch<ALLOW_TC>(a, dim3(blocks, a.splits), x_dt, w_dt, round_w,
                            st, nullptr);
}

// How many clusters of `splits` blocks of the kernel that gemv_launch picks
// for these dtypes and `rows` rows fit on the card at once.
static int gemv_max_clusters(int x_dt, int w_dt, bool round_w, int rows,
                             int splits, int* out) {
  if (rows < 1 || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  GemvArgs a = {};
  a.B = rows;
  a.M = 1;
  return dispatch<true>(a, dim3(1, splits), x_dt, w_dt, round_w, nullptr,
                        out);
}

}  // namespace rt
