// ssd_scan for Hopper: the Mamba2 SSD (state-space duality) scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_kernel (pallas_call
// in ssd_scan). Per (batch, head) row, with u_s = dt_s x_s, dA_t = dt_t A and
// cs the running sum of dA inside a tile,
//   y_q   = sum_{s<=q} exp(cs_q - cs_s) (C_q . B_s) u_s + exp(cs_q) C_q . state^T
//   state = exp(cs_last) state + sum_s exp(cs_last - cs_s) u_s (x) B_s
// with the state (hp, n) in f32 carried from tile to tile; y comes out in x's
// dtype and the final state in f32. Every tile length gives the same
// function up to rounding (the decay of a step is exp(dA_t) whichever tile
// holds it), so the kernel uses its own 64-step tile, whatever chunk the
// caller's plain version uses, and masks a ragged last tile (a step past S
// has dt = 0 and x = 0: it decays by 1 and adds nothing) instead of padding.
//
// What bounds it on the H100: at the full-width prompt pass (one prompt of
// 256 tokens, 32 heads, hp 64, n 128, one group) the chunked algorithm is
// ~0.3 GFLOP of products on ~5 MB: a few microseconds at either peak, so
// what costs is the chain of dependent steps. The chunked algorithm as
// Mamba2's own GPU kernels split it (chunk state, state passing, chunk
// scan), so that only an elementwise pass walks the tiles in order:
//   (1) ssd_chunk_kernel, grid (tiles, batch x (heads + groups)), all tiles
//       in parallel. A block per (batch, head, tile) computes the tile's
//       own end-state contribution (u o decay)^T B, an (hp x 64)(64 x n)
//       product, and exp(cs_last) into a workspace; a block per (batch,
//       group, tile) computes C B^T (64 x n)(n x 64) once for the group's
//       heads (the blocks above the diagonal written as zeros). B and C are
//       read at head / (H / G), never repeated.
//   (2) ssd_pass_kernel, grid (hp n / 512, batch x heads): the carry, 4
//       state elements a thread, the tiles in order (4 at S = 256): the
//       state before each tile replaces that tile's contribution in the
//       workspace, state = exp(cs_last) state + contribution in f32; the
//       final state out.
//   (3) ssd_out_kernel, grid (tiles, batch x heads, hp / 64), all tiles in
//       parallel: y_diag = (C B^T o L) u, a (64 x 64)(64 x hp) product with
//       the decays L = exp(cs_q - cs_s) applied in f32 as the operand is
//       built, and y_off = exp(cs_q) C state^T, a (64 x n)(n x hp) product
//       from the state before the tile.
//   Each warp of (1) and (3) holds its A fragment across 4-8 independent
//   accumulators (n8 tiles), so that the tensor cores' latency overlaps.
//   The products run on the tensor cores as 3xTF32 (mma.sync.m16n8k8):
//   each f32 operand split a = a_hi + a_lo with a_hi = tf32(a), a_lo =
//   tf32(a - a_hi), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi with f32
//   sums. Error bound per product: |a_lo b_lo| plus the rounding of the
//   lo halves, <= 3 * 2^-22 |a| |b| (7.2e-7 |a b|), so an output sums to
//   within ~7.2e-7 sum |a_k b_k| plus f32 rounding, far inside the 1e-3 the
//   checks hold it to (bf16 halves would give 3 * 2^-18, 16 times that).
//   The decays exp(cs_q - cs_s), exp(cs_last - cs_s) dt_s and exp(cs_q) and
//   the state's update stay in f32.
// Shared-memory strides are chosen so that each fragment load of a warp
// falls in 32 different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int kL = 64;                  // time steps per tile
constexpr int kMaxN = 256;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// d += a b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  ptx::mma_tf32(d, al, bh0, bh1);
  ptx::mma_tf32(d, ah, bl0, bl1);
  ptx::mma_tf32(d, ah, bh0, bh1);
}

// An A fragment (rows g, g + 8; columns t, t + 4) from four f32 values,
// split hi / lo.
__device__ __forceinline__ void frag_a(float v0, float v1, float v2, float v3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  ptx::split_tf32(v0, hi[0], lo[0]);
  ptx::split_tf32(v1, hi[1], lo[1]);
  ptx::split_tf32(v2, hi[2], lo[2]);
  ptx::split_tf32(v3, hi[3], lo[3]);
}

// cs[s] = sum_{s' <= s} dt[s'] a over one tile (inclusive), by one warp, two
// steps a lane; both launches run this, so both see the same decays. Also
// ecs[s] = exp(cs[s]).
__device__ __forceinline__ void tile_cumsum(const float* dts, float a,
                                            float* cs, float* ecs, int lane) {
  const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
  float inc = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + v0, c1 = c0 + v1;
  cs[2 * lane] = c0;
  cs[2 * lane + 1] = c1;
  if (ecs) {
    ecs[2 * lane] = expf(c0);
    ecs[2 * lane + 1] = expf(c1);
  }
}

// rows x cols elements (row r at src + r * src_ld; rows >= nvalid zero) into
// shared memory at stride ld: 16-byte cp.async copies when vec (cols *
// sizeof(T) a multiple of 16, rows 16-byte aligned), else element copies.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      size_t src_ld, int rows, int nvalid,
                                      int cols, bool vec, int t) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int cpr = cols / E;
    for (int i = t; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i % cpr) * E;
      const bool ok = r < nvalid;
      ptx::cp_async16(dst + r * ld + c, ok ? src + r * src_ld + c : src, ok);
    }
  } else {
    for (int i = t; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i % cols;
      dst[r * ld + c] = r < nvalid ? src[r * src_ld + c] : zero<T>();
    }
  }
}

// columns c0 .. c1 of rows x ld: zero (pads no copy writes)
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int ld, int rows, int c0,
                                          int c1, int t) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int i = t; i < rows * w; i += blockDim.x)
    dst[(i / w) * ld + c0 + i % w] = zero<T>();
}

enum Vec : int { kVecX = 1, kVecBC = 2 };

constexpr int kWide = 256;              // threads of launches 1 and 3
constexpr int kWideWarps = kWide / 32;

// The workspace, in floats: the tiles' state contributions (then the states
// before each tile) (batch * H, T, P, NP); C B^T (batch * G, T, kL, kL);
// exp(cs_last) (batch * H, T).
struct Ws {
  float *st, *cb, *el;
};
__host__ __device__ inline Ws ws_parts(float* ws, int batch, int H, int G,
                                       int P, int NP, int T) {
  Ws w;
  w.st = ws;
  w.cb = w.st + (size_t)batch * H * T * P * NP;
  w.el = w.cb + (size_t)batch * G * T * kL * kL;
  return w;
}

// Launch 1, all tiles in parallel: a block per (batch, head, tile) for the
// tile's state contribution st[p][n] = sum_s exp(cs_last - cs_s) dt_s
// x_s[p] B_s[n] (hp x n at NP columns) and exp(cs_last); a block per
// (batch, group, tile) for C B^T (64 x 64; the blocks above the diagonal
// zero). A warp computes 16 rows by up to 64 columns with its A fragment
// held across 8 independent accumulators.
template <typename TX, int NP>
__global__ void __launch_bounds__(kWide) ssd_chunk_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ ws, int batch, int S,
    int H, int P, int G, int N, int T, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int tile = blockIdx.x, t0 = tile * kL;
  const int nrow = min(kL, S - t0);
  const int y = blockIdx.y;
  const Ws w = ws_parts(ws, batch, H, G, P, NP, T);

  if (y < batch * H) {
    // ---- the tile's state contribution of one head ----
    const int bi = y / H, hi = y % H, gi = hi / (H / G);
    constexpr int LB = NP + 8;          // B[s][n]: B-fragment reads by (t, g)
    constexpr int NC = NP < 64 ? NP : 64, NT = NC / 8;
    const int PP = (P + 15) / 16 * 16;
    const int LX = PP + 8;              // x[s][p]: A^T-fragment reads
    float* Bs = smem;                                      // [kL][LB]
    TX* Xs = reinterpret_cast<TX*>(Bs + kL * LB);          // [kL][LX]
    float* dts = reinterpret_cast<float*>(Xs + kL * LX);   // [kL]
    float* cs = dts + kL;
    float* wdec = cs + kL;              // exp(cs_last - cs_s) dt_s
    zero_cols(Bs, LB, kL, N, NP, t);
    zero_cols(Xs, LX, kL, P, PP, t);
    stage(Bs, LB, Bm + ((size_t)(bi * S + t0) * G + gi) * N, (size_t)G * N,
          kL, nrow, N, vec & kVecBC, t);
    stage(Xs, LX, x + ((size_t)(bi * S + t0) * H + hi) * P, (size_t)H * P, kL,
          nrow, P, vec & kVecX, t);
    if (t < kL) dts[t] = t < nrow ? dt[(size_t)(bi * S + t0 + t) * H + hi] : 0.f;
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) tile_cumsum(dts, A[y], cs, nullptr, lane);
    __syncthreads();
    if (t < kL) wdec[t] = expf(cs[kL - 1] - cs[t]) * dts[t];
    if (t == 0) w.el[(size_t)y * T + tile] = expf(cs[kL - 1]);
    __syncthreads();

    // (hp x 64)(64 x n): a warp per (16 rows of hp, NC columns of n)
    float* out = w.st + ((size_t)y * T + tile) * P * NP;
    const int mts = PP / 16, ncs = NP / NC;
    for (int it = warp; it < mts * ncs; it += kWideWarps) {
      const int mt = it % mts, n0 = (it / mts) * NC;
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 2
      for (int k8 = 0; k8 < kL / 8; ++k8) {
        const int s0 = 8 * k8 + tq, s1 = s0 + 4;
        const float w0 = wdec[s0], w1 = wdec[s1];
        const TX* x0 = Xs + s0 * LX + 16 * mt + g;
        const TX* x1 = Xs + s1 * LX + 16 * mt + g;
        uint32_t ah[4], al[4];  // A[p][s] = w_s x_s[p]
        frag_a(w0 * to_f32(x0[0]), w0 * to_f32(x0[8]), w1 * to_f32(x1[0]),
               w1 * to_f32(x1[8]), ah, al);
        const float* b0 = Bs + s0 * LB + n0 + g;
        const float* b1 = Bs + s1 * LB + n0 + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh0, bl0, bh1, bl1;  // B[s][n]
          ptx::split_tf32(b0[8 * nt], bh0, bl0);
          ptx::split_tf32(b1[8 * nt], bh1, bl1);
          mma3(acc[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = 16 * mt + g + 8 * hf;
          if (p < P)
            *reinterpret_cast<float2*>(out + (size_t)p * NP + n0 + 8 * nt +
                                       2 * tq) =
                make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
        }
    }
    return;
  }

  // ---- C B^T of one group, shared by its heads ----
  const int yy = y - batch * H, bi = yy / G, gi = yy % G;
  constexpr int LC = NP + 4;            // C[q][n], B[s][n]: A / B^T fragments
  float* Cs = smem;
  float* Bs = Cs + kL * LC;
  zero_cols(Cs, LC, kL, N, NP, t);
  zero_cols(Bs, LC, kL, N, NP, t);
  const size_t off = ((size_t)(bi * S + t0) * G + gi) * N;
  stage(Cs, LC, Cm + off, (size_t)G * N, kL, nrow, N, vec & kVecBC, t);
  stage(Bs, LC, Bm + off, (size_t)G * N, kL, nrow, N, vec & kVecBC, t);
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  __syncthreads();
  float* out = w.cb + ((size_t)yy * T + tile) * kL * kL;
  // a warp per (16 rows q, 32 columns s); n8 tiles above the diagonal zero
  {
    const int mi = warp % 4, s0 = 32 * (warp / 4);
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const int live = min(4, max(0, (16 * mi + 16 - s0 + 7) / 8));  // n8 tiles
    if (live > 0) {
      const float* c0 = Cs + (16 * mi + g) * LC + tq;
      const float* c1 = c0 + 8 * LC;
#pragma unroll 2
      for (int k8 = 0; k8 < NP / 8; ++k8) {
        uint32_t ah[4], al[4];
        frag_a(c0[8 * k8], c1[8 * k8], c0[8 * k8 + 4], c1[8 * k8 + 4], ah, al);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= live) break;  // warp-uniform
          const float* b = Bs + (s0 + 8 * nt + g) * LC + 8 * k8 + tq;
          uint32_t bh0, bl0, bh1, bl1;  // B^T[n][s] = B[s][n]
          ptx::split_tf32(b[0], bh0, bl0);
          ptx::split_tf32(b[4], bh1, bl1);
          mma3(acc[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = 16 * mi + g + 8 * hf, sc = s0 + 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(out + q * kL + sc) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
  }
}

// Launch 2, the carry: per (batch, head), 4 state elements a thread, the
// tiles in order: the state before tile c replaces tile c's contribution in
// the workspace, then state = exp(cs_last_c) state + contribution. The
// final state goes out.
constexpr int kPassThreads = 128;
template <int NP>
__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(
    float* __restrict__ ws, float* __restrict__ state_out, int batch, int H,
    int P, int G, int N, int T) {
  extern __shared__ __align__(16) float el[];  // [T]
  const int row = blockIdx.y;
  const Ws w = ws_parts(ws, batch, H, G, P, NP, T);
  for (int c = threadIdx.x; c < T; c += kPassThreads)
    el[c] = w.el[(size_t)row * T + c];
  __syncthreads();
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= P * NP) return;
  float4* st = reinterpret_cast<float4*>(w.st + (size_t)row * T * P * NP + e);
  const size_t step = (size_t)P * NP / 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 nxt = T > 0 ? __ldcg(st) : s;
  for (int c = 0; c < T; ++c) {
    const float4 cur = nxt;
    if (c + 1 < T) nxt = __ldcg(st + (c + 1) * step);
    st[c * step] = s;
    const float d = el[c];
    s = make_float4(d * s.x + cur.x, d * s.y + cur.y, d * s.z + cur.z,
                    d * s.w + cur.w);
  }
  const int p = e / NP, n = e % NP;
  float* o = state_out + ((size_t)row * P + p) * N;
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) o[n + j] = v[j];
}

// Launch 3, all tiles in parallel: a block per (batch, head, tile, 64
// columns of hp): y = (C B^T o L)(dt x) + exp(cs_q) C state^T with the
// state before the tile from launch 2. A warp per (16 rows q, 32 columns
// of hp): 4 n8 tiles for each product, its A fragments held across them.
template <typename TX, int NP>
struct OutLayout {
  static constexpr int LCB = kL + 4, LC = NP + 4, LXO = 64 + 8;
  static constexpr int kCB = 0;
  static constexpr int kC = kCB + kL * LCB;
  static constexpr int kST = kC + kL * LC;
  static constexpr int kX = kST + 64 * LC;
  static constexpr int kDt = kX + (kL * LXO * (int)sizeof(TX) + 15) / 16 * 4;
  static constexpr int kCs = kDt + kL;
  static constexpr int kEcs = kCs + kL;
  static constexpr int kFloats = kEcs + kL;
};

template <typename TX, int NP>
__global__ void __launch_bounds__(kWide) ssd_out_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Cm,
    float* __restrict__ ws, TX* __restrict__ y, int batch, int S, int H,
    int P, int G, int N, int T, int vec) {
  typedef OutLayout<TX, NP> Lay;
  constexpr int LCB = Lay::LCB, LC = Lay::LC, LXO = Lay::LXO;
  extern __shared__ __align__(16) float smem[];
  float* CB = smem + Lay::kCB;
  float* Cs = smem + Lay::kC;
  float* Ps = smem + Lay::kST;          // the state before the tile [p][n]
  TX* Xs = reinterpret_cast<TX*>(smem + Lay::kX);
  float* dts = smem + Lay::kDt;
  float* cs = smem + Lay::kCs;
  float* ecs = smem + Lay::kEcs;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int tile = blockIdx.x, t0 = tile * kL, nrow = min(kL, S - t0);
  const int row = blockIdx.y, bi = row / H, hi = row % H, gi = hi / (H / G);
  const int p0 = 64 * blockIdx.z, pw = min(64, P - p0);
  const Ws w = ws_parts(ws, batch, H, G, P, NP, T);

  zero_cols(Cs, LC, kL, N, NP, t);
  zero_cols(Xs, LXO, kL, pw, 64, t);
  stage(CB, LCB, w.cb + ((size_t)(bi * G + gi) * T + tile) * kL * kL,
        (size_t)kL, kL, kL, kL, true, t);
  stage(Cs, LC, Cm + ((size_t)(bi * S + t0) * G + gi) * N, (size_t)G * N, kL,
        nrow, N, vec & kVecBC, t);
  stage(Ps, LC, w.st + (((size_t)row * T + tile) * P + p0) * NP, (size_t)NP,
        64, pw, NP, true, t);
  stage(Xs, LXO, x + ((size_t)(bi * S + t0) * H + hi) * P + p0, (size_t)H * P,
        kL, nrow, pw, vec & kVecX, t);
  if (t < kL) dts[t] = t < nrow ? dt[(size_t)(bi * S + t0 + t) * H + hi] : 0.f;
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) tile_cumsum(dts, A[row], cs, ecs, lane);
  __syncthreads();

  const int mi = warp % 4, pc = 32 * (warp / 4);  // rows 16 mi; columns pc
  if (pc >= pw) return;                           // warp-uniform
  const int q0 = 16 * mi + g, q1 = q0 + 8;
  float accd[4][4], acco[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) accd[nt][e] = acco[nt][e] = 0.f;
  // y_diag over s <= q: the s columns of blocks 0 .. mi
  auto mval = [&](int q, int s) {
    return s <= q ? CB[q * LCB + s] * expf(cs[q] - cs[s]) : 0.f;
  };
  for (int k8 = 0; k8 < 2 * mi + 2; ++k8) {
    const int s0 = 8 * k8 + tq, s1 = s0 + 4;
    uint32_t ah[4], al[4];
    frag_a(mval(q0, s0), mval(q1, s0), mval(q0, s1), mval(q1, s1), ah, al);
    const float d0 = dts[s0], d1 = dts[s1];
    const TX* x0 = Xs + s0 * LXO + pc + g;
    const TX* x1 = Xs + s1 * LXO + pc + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;  // B[s][p] = dt_s x_s[p]
      ptx::split_tf32(d0 * to_f32(x0[8 * nt]), bh0, bl0);
      ptx::split_tf32(d1 * to_f32(x1[8 * nt]), bh1, bl1);
      mma3(accd[nt], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  // y_off: C state^T over n
  {
    const float* c0 = Cs + q0 * LC + tq;
    const float* c1 = Cs + q1 * LC + tq;
#pragma unroll 2
    for (int k8 = 0; k8 < NP / 8; ++k8) {
      uint32_t ah[4], al[4];
      frag_a(c0[8 * k8], c1[8 * k8], c0[8 * k8 + 4], c1[8 * k8 + 4], ah, al);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* sr = Ps + (pc + 8 * nt + g) * LC + 8 * k8 + tq;
        uint32_t bh0, bl0, bh1, bl1;  // state^T[n][p] = state[p][n]
        ptx::split_tf32(sr[0], bh0, bl0);
        ptx::split_tf32(sr[4], bh1, bl1);
        mma3(acco[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = hf ? q1 : q0;
      if (q >= nrow) continue;
      TX* yr = y + ((size_t)(bi * S + t0 + q) * H + hi) * P + p0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pcol = pc + 8 * nt + 2 * tq + e;
        if (pcol < pw)
          store_as(yr + pcol, accd[nt][2 * hf + e] + ecs[q] * acco[nt][2 * hf + e]);
      }
    }
}

template <typename TX, int NP>
size_t chunk_smem(int P) {
  const int PP = (P + 15) / 16 * 16;
  const size_t st = (size_t)kL * (NP + 8) * 4 + (size_t)kL * (PP + 8) * sizeof(TX) +
                    3 * kL * 4;
  const size_t cb = 2 * (size_t)kL * (NP + 4) * 4;
  return st > cb ? st : cb;
}

template <int NP>
size_t workspace_floats(int batch, int S, int H, int P, int G) {
  const size_t T = (S + kL - 1) / kL;
  return (size_t)batch * H * T * P * NP + (size_t)batch * G * T * kL * kL +
         (size_t)batch * H * T;
}

// Calls f(std::integral_constant<int, NP>()) with n padded to 16 .. 256.
template <class F>
auto with_np(int N, F&& f) -> decltype(f(std::integral_constant<int, 16>())) {
  if (N <= 16) return f(std::integral_constant<int, 16>());
  if (N <= 32) return f(std::integral_constant<int, 32>());
  if (N <= 64) return f(std::integral_constant<int, 64>());
  if (N <= 128) return f(std::integral_constant<int, 128>());
  return f(std::integral_constant<int, 256>());
}

template <typename TX, int NP>
int launch_typed(const void* xv, const float* dt, const float* A,
                 const float* B, const float* C, void* yv, float* state,
                 float* ws, int batch, int S, int H, int P, int G, int N,
                 cudaStream_t st) {
  const TX* x = static_cast<const TX*>(xv);
  TX* y = static_cast<TX*>(yv);
  const int T = (S + kL - 1) / kL;
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = ((P * (int)sizeof(TX)) % 16 == 0 && a16(x) ? kVecX : 0) |
                  (N % 4 == 0 && a16(B) && a16(C) ? kVecBC : 0);
  cudaError_t e;
  if (T > 0) {
    auto k1 = ssd_chunk_kernel<TX, NP>;
    const size_t s1 = chunk_smem<TX, NP>(P);
    e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s1);
    if (e != cudaSuccess) return (int)e;
    k1<<<dim3(T, batch * (H + G)), kWide, s1, st>>>(x, dt, A, B, C, ws, batch,
                                                     S, H, P, G, N, T, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int per = kPassThreads * 4;
  ssd_pass_kernel<NP><<<dim3((P * NP + per - 1) / per, batch * H), kPassThreads,
                         (size_t)T * 4, st>>>(ws, state, batch, H, P, G, N, T);
  e = cudaGetLastError();
  if (e != cudaSuccess || T == 0) return (int)e;
  auto k3 = ssd_out_kernel<TX, NP>;
  const size_t s3 = OutLayout<TX, NP>::kFloats * sizeof(float);
  e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s3);
  if (e != cudaSuccess) return (int)e;
  k3<<<dim3(T, batch * H, (P + 63) / 64), kWide, s3, st>>>(
      x, dt, A, C, ws, y, batch, S, H, P, G, N, T, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the workspace ssd_scan_launch needs for these shapes: the
// tiles' state contributions (batch, H, tiles, P, n padded), C B^T per
// (batch, group, tile) and exp(cs_last) per (batch, head, tile).
extern "C" long long ssd_scan_workspace(int batch, int S, int H, int P, int G,
                                        int N) {
  if (N < 1 || N > kMaxN) return -1;
  return with_np(N, [&](auto np) {
    return (long long)workspace_floats<decltype(np)::value>(batch, S, H, P, G);
  });
}

// Model layout: x, y (batch, S, H, P) in x_dtype (0 f32, 1 bf16); dt
// (batch, S, H), A (batch, H), B, C (batch, S, G, N), state (batch, H, P, N),
// all f32 and contiguous; ws: ssd_scan_workspace(...) floats. H a multiple
// of G, 1 <= N <= 256. Three launches on `stream`; returns the first
// launch error.
extern "C" int ssd_scan_launch(const void* x, int x_dtype, const float* dt,
                               const float* A, const float* B, const float* C,
                               void* y, float* state, float* ws, int batch,
                               int S, int H, int P, int G, int N,
                               void* stream) {
  if (N < 1 || N > kMaxN || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (batch * H == 0 || P == 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_np(N, [&](auto np) {
    constexpr int NP = decltype(np)::value;
    if (x_dtype == kF32)
      return launch_typed<float, NP>(x, dt, A, B, C, y, state, ws, batch, S, H,
                                     P, G, N, st);
    return launch_typed<__nv_bfloat16, NP>(x, dt, A, B, C, y, state, ws, batch,
                                           S, H, P, G, N, st);
  });
}
