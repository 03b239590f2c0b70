// Width-gated skinny matrix product shared by morph_matmul.cu and
// fused_decode.cu: out[r, n] = sum_k x[r, k] * w[k, n] for rows r of a
// (B*M, K) activation and a (K, N) row-major weight, with per-batch gates
//   * columns n >= active_n[b] come out as exact zeros,
//   * contraction rows k >= active_k[b] contribute nothing,
// where b = r / M. Accumulation is in f32.
//
// Replaces the TPU kernel src/repro/kernels/morph_matmul.py:_kernel. What
// bounds it on the H100: at decode, M = 1 per slot and B ~ 8, so each weight
// element feeds 2*B flops and the product is bound by the bytes of the
// weight (f32 master weights: 4 B/element, ~3.35 TB/s). The TPU grid walks
// (B, M/bm, N/bn, K/bk), which streams the whole weight once per batch row.
// Here one block owns a 32-column tile of the output for ALL rows, so each
// weight byte is read from device memory once per launch. 256 threads split
// their share of the contraction dimension 32 ways, and each thread issues
// all 8 of a 256-row chunk's weight loads, then its x loads, before it
// waits on any. A
// 2048-column weight has only 64 tiles, too few to keep 132 SMs reading, so
// the contraction is also split across blocks (grid.y): each split writes an
// f32 partial, and the last split of a tile to finish (an atomic ticket)
// adds the partials in split order — deterministic, one launch. The gates
// are read from device memory by every block (never a host round trip): a
// column tile at or past max_b active_n reads no weights and writes zeros,
// contraction rows at or past max_b active_k are skipped for the whole tile,
// and narrower rows inside a live tile are masked per row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;
constexpr int kColLanes = 8;                  // 4 columns per lane
constexpr int kBN = 4 * kColLanes;            // 32 output columns per block
constexpr int kKLanes = kThreads / kColLanes; // 32 lanes down K
constexpr int kRows = 8;                      // rows held in registers at once
constexpr int kKC = 256;                      // K rows staged per chunk
constexpr int kUnroll = kKC / kKLanes;        // 8 weight loads in flight
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSeg = 3;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive weight columns n..n+3 of one weight row, as f32. Returned
// by value: an array out-parameter would put the loads in local memory.
template <bool VEC>
__device__ __forceinline__ float4 load_w4(const float* row, int n, int N) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row + n));
  float4 o;
  o.x = n < N ? __ldg(row + n) : 0.f;
  o.y = n + 1 < N ? __ldg(row + n + 1) : 0.f;
  o.z = n + 2 < N ? __ldg(row + n + 2) : 0.f;
  o.w = n + 3 < N ? __ldg(row + n + 3) : 0.f;
  return o;
}
template <bool VEC>
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* row, int n, int N) {
  float4 o;
  if (VEC) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + n));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    o.x = __low2float(a); o.y = __high2float(a);
    o.z = __low2float(b); o.w = __high2float(b);
  } else {
    o.x = n < N ? __bfloat162float(row[n]) : 0.f;
    o.y = n + 1 < N ? __bfloat162float(row[n + 1]) : 0.f;
    o.z = n + 2 < N ? __bfloat162float(row[n + 2]) : 0.f;
    o.w = n + 3 < N ? __bfloat162float(row[n + 3]) : 0.f;
  }
  return o;
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
  int splits;      // contraction splits per tile (grid.y)
  int k_per_split; // contraction rows per split, a multiple of kKC
  float* ws;       // (splits, B*M, sum of N) f32 partials when splits > 1
  int ws_cols;     // sum of N over the segments
  int* tickets;    // one zeroed int per tile when splits > 1; left zeroed
};

// ROUND: round each weight to bf16 before the multiply (the weight cast to
// the activation's bf16 type, done on load instead of as a separate pass).
template <typename TX, typename TW, typename TO, bool VEC, bool ROUND>
__global__ void __launch_bounds__(kThreads, 2) gated_gemv(GemvArgs a) {
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
  TO* out = static_cast<TO*>(outv);
  const int B = a.B, M = a.M, K = a.K, R = B * M;
  const int n0 = tile * kBN;
  const int split = blockIdx.y;
  const int t = threadIdx.x;

  __shared__ int s_lim[2];
  __shared__ float xs[kRows][kKC];
  __shared__ float red[kWarps][kRows][kBN];
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
        if (n < N) store_as(out + (size_t)r * N + n, 0.f);
      }
    }
    return;
  }

  const int kb = split * a.k_per_split;
  const int ke = min(maxK, kb + a.k_per_split);
  const bool partial = a.splits > 1;
  const TX* x = static_cast<const TX*>(a.x);
  const int cl = t % kColLanes, kl = t / kColLanes;
  const int n = n0 + 4 * cl;
  __shared__ int s_kr[kRows];  // live contraction rows of each staged row
  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int nr = min(kRows, R - r0);
    if (t < kRows) {
      const int row = r0 + t;
      s_kr[t] = t >= nr ? 0 : (a.ak ? min(a.ak[row / M], ke) : ke);
    }
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

    for (int k0 = kb; k0 < ke; k0 += kKC) {
      // issue this chunk's weight loads first: they do not depend on x, so
      // their latency overlaps the staging of x below
      float4 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + kl + u * kKLanes;
        wv[u] = (n < N && k < ke) ? load_w4<VEC>(w + (size_t)k * N, n, N)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();  // previous chunk's xs consumed; s_kr visible
      // all of this thread's x loads first, then the stores: a store right
      // after its load would wait out one memory round trip per element
      constexpr int kXPer = kRows * kKC / kThreads;
      float xv[kXPer];
#pragma unroll
      for (int u = 0; u < kXPer; ++u) {
        const int i = t + u * kThreads, r = i / kKC, k = k0 + i % kKC;
        xv[u] = k < s_kr[r] ? to_f32(x[(size_t)(r0 + r) * K + k]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kXPer; ++u) {
        const int i = t + u * kThreads;
        xs[i / kKC][i % kKC] = xv[u];
      }
      __syncthreads();
      if (n < N) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float4 wq = wv[u];
          if (ROUND) {
            wq.x = round_bf16(wq.x); wq.y = round_bf16(wq.y);
            wq.z = round_bf16(wq.z); wq.w = round_bf16(wq.w);
          }
          const int kk = kl + u * kKLanes;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xv = xs[r][kk];
            acc[r][0] = fmaf(xv, wq.x, acc[r][0]);
            acc[r][1] = fmaf(xv, wq.y, acc[r][1]);
            acc[r][2] = fmaf(xv, wq.z, acc[r][2]);
            acc[r][3] = fmaf(xv, wq.w, acc[r][3]);
          }
        }
      }
    }

    // reduce the 4 K-lanes inside each warp (lanes cl, cl+8, cl+16, cl+24),
    // then the 8 warps through shared memory
    const int lane = t % 32, wid = t / 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[r][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][j] = v;
      }
    if (lane < kColLanes) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[wid][r][4 * lane + j] = acc[r][j];
    }
    __syncthreads();
    {
      const int r = t / kBN, c = t % kBN;  // kThreads == kRows * kBN
      const int nn = n0 + c;
      if (r < nr && nn < N) {
        float v = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) v += red[wi][r][c];
        const int row = r0 + r;
        if (partial) {
          a.ws[((size_t)split * R + row) * a.ws_cols + col0 + nn] = v;
        } else {
          const bool live = !an || nn < an[row / M];
          store_as(out + (size_t)row * N + nn, live ? v : 0.f);
        }
      }
    }
    __syncthreads();  // red is rewritten by the next row chunk
  }
  if (!partial) return;

  // the last split of this tile to finish adds the partials in split order
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const int ticket = atomicAdd(&a.tickets[blockIdx.x], 1);
    s_last = ticket == a.splits - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = t; i < R * kBN; i += kThreads) {
    const int row = i / kBN, nn = n0 + i % kBN;
    if (nn >= N) continue;
    float v = 0.f;
    for (int s = 0; s < a.splits; ++s)
      v += __ldcg(a.ws + ((size_t)s * R + row) * a.ws_cols + col0 + nn);
    const bool live = !an || nn < an[row / M];
    store_as(out + (size_t)row * N + nn, live ? v : 0.f);
  }
  if (t == 0) a.tickets[blockIdx.x] = 0;  // ready for the next launch
}

template <typename TX, typename TW, typename TO>
static void launch_typed(const GemvArgs& a, dim3 grid, bool vec, bool round,
                         cudaStream_t st) {
  if (vec) {
    if (round) gated_gemv<TX, TW, TO, true, true><<<grid, kThreads, 0, st>>>(a);
    else gated_gemv<TX, TW, TO, true, false><<<grid, kThreads, 0, st>>>(a);
  } else {
    if (round) gated_gemv<TX, TW, TO, false, true><<<grid, kThreads, 0, st>>>(a);
    else gated_gemv<TX, TW, TO, false, false><<<grid, kThreads, 0, st>>>(a);
  }
}

template <typename TX, typename TW>
static void launch_out(const GemvArgs& a, dim3 grid, int out_dt, bool vec,
                       bool round, cudaStream_t st) {
  if (out_dt == kF32) launch_typed<TX, TW, float>(a, grid, vec, round, st);
  else launch_typed<TX, TW, __nv_bfloat16>(a, grid, vec, round, st);
}

// Launch over a.nseg products that share x. dtype codes: 0 f32, 1 bf16.
// vec: every weight is 16-byte (f32) / 8-byte (bf16) aligned with N % 4 == 0.
// a.splits / k_per_split / ws / tickets come from the caller's plan
// (kernels/morph_matmul.py: plan): k_per_split a multiple of kKC, ws holding
// splits * B*M * sum-of-N floats, one zeroed ticket per tile; splits == 1
// needs neither. Returns cudaGetLastError().
static int gemv_launch(GemvArgs a, int x_dt, int w_dt, int out_dt, bool vec,
                       bool round_w, cudaStream_t st) {
  int blocks = 0;
  a.ws_cols = 0;
  for (int i = 0; i < a.nseg; ++i) {
    a.seg[i].tiles = (a.seg[i].N + kBN - 1) / kBN;
    blocks += a.seg[i].tiles;
    a.ws_cols += a.seg[i].N;
  }
  if (blocks == 0 || a.B * a.M == 0) return (int)cudaGetLastError();
  const dim3 grid(blocks, a.splits);
  const bool round = round_w && w_dt == kF32;  // bf16 weights are already bf16
  if (x_dt == kF32) {
    if (w_dt == kF32) launch_out<float, float>(a, grid, out_dt, vec, round, st);
    else launch_out<float, __nv_bfloat16>(a, grid, out_dt, vec, round, st);
  } else {
    if (w_dt == kF32) launch_out<__nv_bfloat16, float>(a, grid, out_dt, vec, round, st);
    else launch_out<__nv_bfloat16, __nv_bfloat16>(a, grid, out_dt, vec, round, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace rt
