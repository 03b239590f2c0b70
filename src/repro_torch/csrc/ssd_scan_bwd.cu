// ssd_scan backward for Hopper: the gradient of the Mamba2 SSD scan.
//
// Replaces no TPU kernel: the reference differentiates its chunked scan
// (src/repro/models/ssm.py:ssd_chunked) with XLA, and its Pallas scan
// (src/repro/kernels/ssd_scan.py) has no backward. The port's forward is a
// hand kernel (ssd_scan.cu), so its gradient is one too: without it a
// Mamba2 loss.backward() on the card would drop every gradient through the
// scan.
//
// Per (batch, head) row and per 64-step tile of the forward, with a = dt A,
// cs the inclusive cumsum of a in the tile, u = dt x, h_prev the state
// before the tile (kept by the forward in its workspace), G the gradient
// into the state after the tile, M_ts = exp(cs_t - cs_s) for s <= t,
// w_s = exp(cs_last - cs_s), e_t = exp(cs_t), E = exp(cs_last):
//   du_s  = sum_{t>=s} M_ts (C_t.B_s) dy_t + w_s G B_s
//   dB_s  = sum_{t>=s} M_ts (dy_t.u_s) C_t + w_s G^T u_s
//   dC_t  = sum_{s<=t} M_ts (dy_t.u_s) B_s + e_t h_prev^T dy_t
//   G_prev = E G + sum_t e_t dy_t (x) C_t
// and the decay gradient dcs_t (every exp above differentiated in cs),
// reverse-summed in the tile into da; then ddt = A da + <du, x>, dx = dt du,
// dA = sum dt da. Every exponent evaluated is <= 0 (a <= 0, so the cumsum
// never rises), so nothing overflows at any decay; the masked M_ts is never
// evaluated above the diagonal.
//
// Four launches, as the forward's three plus a sum:
//   (1) ssd_bwd_carry_kernel, grid (tiles, batch x heads): each tile's
//       sum_t e_t dy_t (x) C_t (hp x n) into the workspace.
//   (2) ssd_bwd_pass_kernel, grid (hp n / 256, batch x heads): the reverse
//       carry, the tiles from last to first: the gradient into the state
//       after each tile replaces that tile's term, starting from the final
//       state's gradient.
//   (3) ssd_bwd_tile_kernel, grid (tiles, batch x heads): a tile's every
//       term, from the tile's inputs, C.B^T of the forward's workspace, the
//       state before the tile and the gradient after it: dx, ddt, the
//       head's dB and dC, its share of dA.
//   (4) ssd_bwd_sum_kernel: dB and dC summed over each group's heads (B and
//       C are shared per group), dA over the tiles.
// No atomics anywhere: every sum runs in a fixed order, so a launch on the
// same inputs gives the same bits. In launch 3 the per-step decay terms are
// reduced from staged tiles (V = Q o CB, row sums minus column sums) and
// from each thread's partials in shared memory ([step][tx]), one thread a
// step adding them in index order; <G, h_prev> is a warp-shuffle tree per
// warp, then the 8 warp sums in order.
// Products are f32 FMAs from shared memory: each thread of 256 holds a 4 x 4
// register tile of a 64 x 64 output (rows ty + 16 i, columns tx + 16 j), and
// reads the right operand along a row of shared memory (64 x 64 chunks
// staged at stride 65). What bounds it on the H100: at the Mamba2-370M
// training shape (8 x 256 steps, 32 heads of 64, n = 128) launch 3 does
// ~3.1 M FMAs per (row, tile), ~6.4 GFLOP in all against ~70 MB of
// operands: the f32 FMA rate, at ~2 operand loads from shared memory per 4
// FMAs. Tensor cores (the forward's 3xTF32) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;      // time steps per tile: the forward's tile
constexpr int kMaxN = 256;  // as the forward
constexpr int kC = 64;      // columns of a staged chunk
constexpr int kLds = kC + 1;
constexpr int kChunk = kL * kLds;  // floats of one staged 64 x 64 chunk
constexpr int kThreads = 256;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// n padded as the forward pads it (its workspace's state stride)
__host__ __device__ inline int np_of(int N) {
  return N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : N <= 128 ? 128 : 256;
}

// The forward's workspace (ssd_scan.cu, ws_parts): the state before each
// tile (batch * H, T, P, NP), C B^T (batch * G, T, kL, kL), exp(cs_last)
// (batch * H, T).
struct Fws {
  const float *st, *cb, *el;
};
__host__ __device__ inline Fws fws_parts(const float* ws, int batch, int H,
                                         int G, int P, int NP, int T) {
  Fws w;
  w.st = ws;
  w.cb = w.st + (size_t)batch * H * T * P * NP;
  w.el = w.cb + (size_t)batch * G * T * kL * kL;
  return w;
}

// This kernel's workspace: the carried gradient (batch * H, T, P, N); the
// heads' dB and dC (batch, S, H, N); each tile's share of dA (batch * H, T).
struct Bws {
  float *gs, *dbh, *dch, *dap;
};
__host__ __device__ inline Bws bws_parts(float* ws, int batch, int S, int H,
                                         int P, int N, int T) {
  Bws w;
  w.gs = ws;
  w.dbh = w.gs + (size_t)batch * H * T * P * N;
  w.dch = w.dbh + (size_t)batch * S * H * N;
  w.dap = w.dch + (size_t)batch * S * H * N;
  return w;
}

// cs (inclusive cumsum of dt a over the tile) by one warp, two steps a lane,
// in the forward's order
__device__ __forceinline__ void tile_cumsum(const float* dts, float a,
                                            float* cs, int lane) {
  const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
  float inc = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  cs[2 * lane] = excl + v0;
  cs[2 * lane + 1] = excl + v0 + v1;
}

// A 64 x 64 chunk into shared memory at stride kLds: element (r, c) from
// src[r * ld + c] (zero at r >= rows or c >= cols), times scale[r] when
// given; at [c][r] when trans.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t ld,
                                      int rows, int cols, bool trans,
                                      const float* scale = nullptr) {
  for (int i = threadIdx.x; i < kL * kC; i += blockDim.x) {
    const int r = i / kC, c = i % kC;
    float v = 0.f;
    if (r < rows && c < cols) v = to_f32(src[(size_t)r * ld + c]);
    if (scale) v *= scale[r];
    dst[trans ? c * kLds + r : r * kLds + c] = v;
  }
}

// acc[i][j] += sum_{k < 64} a(ty + 16 i, k) * bm[k][tx + 16 j]
template <class FA>
__device__ __forceinline__ void mm(float (&acc)[4][4], FA a, const float* bm,
                                   int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kC; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bm[k * kLds + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Launch 1: per (row, tile), the tile's term of the reverse carry,
// sum_t e_t dy_t[p] C_t[n], into gs[row][tile] (P x N).
template <typename TX>
__global__ void __launch_bounds__(kThreads) ssd_bwd_carry_kernel(
    const TX* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Cm,
    float* __restrict__ bws, int batch, int S, int H, int P, int G, int N,
    int T) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;            // e_t dy[t][p]   [t][p]
  float* cts = dys + kChunk;    // C[t][n]        [t][n]
  float* dts = cts + kChunk;
  float* cs = dts + kL;
  float* ecs = cs + kL;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int tile = blockIdx.x, t0 = tile * kL, nrow = min(kL, S - t0);
  const int row = blockIdx.y, bi = row / H, hi = row % H, gi = hi / (H / G);
  const Bws w = bws_parts(bws, batch, S, H, P, N, T);
  if (t < kL) dts[t] = t < nrow ? dt[(size_t)(bi * S + t0 + t) * H + hi] : 0.f;
  __syncthreads();
  if (t < 32) tile_cumsum(dts, A[row], cs, t);
  __syncthreads();
  if (t < kL) ecs[t] = expf(cs[t]);
  __syncthreads();
  float* out = w.gs + ((size_t)row * T + tile) * P * N;
  for (int pc = 0; pc < P; pc += kC) {
    stage(dys, dy + ((size_t)(bi * S + t0) * H + hi) * P + pc, (size_t)H * P,
          nrow, P - pc, false, ecs);
    for (int nc = 0; nc < N; nc += kC) {
      stage(cts, Cm + ((size_t)(bi * S + t0) * G + gi) * N + nc,
            (size_t)G * N, nrow, N - nc, false);
      __syncthreads();
      float acc[4][4];
      zero4(acc);
      mm(acc, [&](int i, int k) { return dys[k * kLds + i]; }, cts, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = pc + ty + 16 * i, n = nc + tx + 16 * j;
          if (p < P && n < N) out[(size_t)p * N + n] = acc[i][j];
        }
      __syncthreads();
    }
  }
}

// Launch 2: the reverse carry. Per row, one state element a thread, the
// tiles from last to first: gs[tile] <- G (the gradient into the state
// after the tile), then G = E_tile G + the tile's term; G starts as the
// final state's gradient.
constexpr int kPassThreads = 256;
__global__ void __launch_bounds__(kPassThreads) ssd_bwd_pass_kernel(
    const float* __restrict__ el, const float* __restrict__ dstate,
    float* __restrict__ bws, int batch, int S, int H, int P, int N, int T) {
  const int row = blockIdx.y;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= P * N) return;
  const Bws w = bws_parts(bws, batch, S, H, P, N, T);
  float* gs = w.gs + (size_t)row * T * P * N + e;
  const size_t step = (size_t)P * N;
  float g = dstate[(size_t)row * P * N + e];
  for (int c = T - 1; c >= 0; --c) {
    const float cur = gs[c * step];
    gs[c * step] = g;
    g = el[(size_t)row * T + c] * g + cur;
  }
}

// Launch 3: per (row, tile), every gradient of the tile. Shared memory:
// P = M o CB and Q = M o D (D_ts = dy_t . u_s) as [t][s], three staged
// chunks, and per-step vectors.
struct TileLayout {
  static constexpr int kP = 0;
  static constexpr int kQ = kP + kChunk;
  static constexpr int kB0 = kQ + kChunk;
  static constexpr int kB1 = kB0 + kChunk;
  static constexpr int kB2 = kB1 + kChunk;
  static constexpr int kDt = kB2 + kChunk;
  static constexpr int kCs = kDt + kL;
  static constexpr int kE = kCs + kL;    // e_t = exp(cs_t)
  static constexpr int kW = kE + kL;     // w_s = exp(cs_last - cs_s)
  static constexpr int kDcs = kW + kL;   // the decay gradient, then da
  static constexpr int kDux = kDcs + kL; // <du_s, x_s>
  static constexpr int kZ = kDux + kL;   // w_s <u_s, G B_s>
  static constexpr int kGH = kZ + kL;    // <G, h_prev>, one per warp
  // per-thread partials [step][tx] of <du, x>, <u, G B> and e o <C, dY h>
  static constexpr int kPx = kGH + kThreads / 32;
  static constexpr int kPz = kPx + kL * 16;
  static constexpr int kPc = kPz + kL * 16;
  static constexpr int kFloats = kPc + kL * 16;
};

template <typename TX>
__global__ void __launch_bounds__(kThreads) ssd_bwd_tile_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ fws,
    const TX* __restrict__ dy, TX* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ bws, int batch, int S, int H, int P, int G, int N,
    int T) {
  typedef TileLayout Lay;
  extern __shared__ __align__(16) float smem[];
  float* Pm = smem + Lay::kP;
  float* Qm = smem + Lay::kQ;
  float* b0 = smem + Lay::kB0;
  float* b1 = smem + Lay::kB1;
  float* b2 = smem + Lay::kB2;
  float* dts = smem + Lay::kDt;
  float* cs = smem + Lay::kCs;
  float* ecs = smem + Lay::kE;
  float* wdec = smem + Lay::kW;
  float* dcs = smem + Lay::kDcs;
  float* dux = smem + Lay::kDux;
  float* zs = smem + Lay::kZ;
  float* gh = smem + Lay::kGH;
  float* px = smem + Lay::kPx;
  float* pz = smem + Lay::kPz;
  float* pcs = smem + Lay::kPc;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int tile = blockIdx.x, t0 = tile * kL, nrow = min(kL, S - t0);
  const int row = blockIdx.y, bi = row / H, hi = row % H, gi = hi / (H / G);
  const int NP = np_of(N);
  const Fws fw = fws_parts(fws, batch, H, G, P, NP, T);
  const Bws w = bws_parts(bws, batch, S, H, P, N, T);
  const size_t xrow = ((size_t)(bi * S + t0) * H + hi) * P;  // (t0, hi, 0)
  const size_t bcrow = ((size_t)(bi * S + t0) * G + gi) * N;
  const float* Gt = w.gs + ((size_t)row * T + tile) * P * N;     // [p][n]
  const float* Ht = fw.st + ((size_t)row * T + tile) * P * NP;   // [p][n]
  const float* CB = fw.cb + ((size_t)(bi * G + gi) * T + tile) * kL * kL;

  if (t < kL) dts[t] = t < nrow ? dt[(size_t)(bi * S + t0 + t) * H + hi] : 0.f;
  __syncthreads();
  const float a = A[row];
  if (t < 32) tile_cumsum(dts, a, cs, t);
  __syncthreads();
  if (t < kL) {
    ecs[t] = expf(cs[t]);
    wdec[t] = expf(cs[kL - 1] - cs[t]);
  }
  __syncthreads();

  // ---- D = dY U^T over p, then P = M o CB, Q = M o D, V = Q o CB (into
  // b2); dcs = V's row sums minus its column sums ----
  {
    float acc[4][4];
    zero4(acc);
    for (int pc = 0; pc < P; pc += kC) {
      stage(b0, dy + xrow + pc, (size_t)H * P, nrow, P - pc, false);  // [t][p]
      stage(b1, x + xrow + pc, (size_t)H * P, nrow, P - pc, true, dts);  // u^T [p][s]
      __syncthreads();
      mm(acc, [&](int i, int k) { return b0[i * kLds + k]; }, b1, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ss = tx + 16 * j;
        float pv = 0.f, qv = 0.f, vv = 0.f;
        if (ss <= tt) {
          const float m = expf(cs[tt] - cs[ss]);
          const float cb = CB[tt * kL + ss];
          pv = m * cb;
          qv = m * acc[i][j];
          vv = qv * cb;
        }
        Pm[tt * kLds + ss] = pv;
        Qm[tt * kLds + ss] = qv;
        b2[tt * kLds + ss] = vv;
      }
    }
  }
  __syncthreads();
  // b2 is next written after the du loop's first barrier
  if (t < kL) {
    float r = 0.f, c = 0.f;
    for (int k = 0; k < kL; ++k) {
      r += b2[t * kLds + k];
      c += b2[k * kLds + t];
    }
    dcs[t] = r - c;
  }

  // ---- du = P^T dY + w o (B G^T), per 64 columns of p; dx, <du, x> and
  // the state term's share of the decay gradient, kept per thread ----
  float rx[4] = {0.f, 0.f, 0.f, 0.f}, rz[4] = {0.f, 0.f, 0.f, 0.f};
  for (int pc = 0; pc < P; pc += kC) {
    float acc[4][4], accs[4][4];
    zero4(acc);
    zero4(accs);
    stage(b0, dy + xrow + pc, (size_t)H * P, nrow, P - pc, false);  // [t][p]
    __syncthreads();
    mm(acc, [&](int i, int k) { return Pm[k * kLds + i]; }, b0, ty, tx);
    for (int nc = 0; nc < N; nc += kC) {
      __syncthreads();
      stage(b1, Bm + bcrow + nc, (size_t)G * N, nrow, N - nc, false);  // [s][n]
      stage(b2, Gt + (size_t)pc * N + nc, (size_t)N, P - pc, N - nc, true);  // G^T [n][p]
      __syncthreads();
      mm(accs, [&](int i, int k) { return b1[i * kLds + k]; }, b2, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ss = ty + 16 * i;
      if (ss >= nrow) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = pc + tx + 16 * j;
        if (p >= P) continue;
        const size_t at = xrow + (size_t)ss * H * P + p;
        const float xv = to_f32(x[at]);
        const float du = acc[i][j] + wdec[ss] * accs[i][j];
        store_as(dx + at, dts[ss] * du);
        rx[i] += du * xv;
        rz[i] += xv * accs[i][j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    px[(ty + 16 * i) * 16 + tx] = rx[i];
    pz[(ty + 16 * i) * 16 + tx] = rz[i];
  }

  // ---- dB (this head's) = Q^T C + w o (U G), per 64 columns of n ----
  for (int nc = 0; nc < N; nc += kC) {
    float acc[4][4], accs[4][4];
    zero4(acc);
    zero4(accs);
    stage(b0, Cm + bcrow + nc, (size_t)G * N, nrow, N - nc, false);  // [t][n]
    __syncthreads();
    mm(acc, [&](int i, int k) { return Qm[k * kLds + i]; }, b0, ty, tx);
    for (int pc = 0; pc < P; pc += kC) {
      __syncthreads();
      stage(b1, x + xrow + pc, (size_t)H * P, nrow, P - pc, false, dts);  // u [s][p]
      stage(b2, Gt + (size_t)pc * N + nc, (size_t)N, P - pc, N - nc, false);  // G [p][n]
      __syncthreads();
      mm(accs, [&](int i, int k) { return b1[i * kLds + k]; }, b2, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ss = ty + 16 * i;
      if (ss >= nrow) continue;
      float* o = w.dbh + ((size_t)(bi * S + t0 + ss) * H + hi) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + tx + 16 * j;
        if (n < N) o[n] = acc[i][j] + wdec[ss] * accs[i][j];
      }
    }
    __syncthreads();
  }

  // ---- dC (this head's) = Q B + e o (dY h_prev), per 64 columns of n;
  // <C_t, (dY h_prev)_t> and <G, h_prev> kept per thread ----
  float ghp = 0.f, rc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int nc = 0; nc < N; nc += kC) {
    float acc[4][4], accs[4][4];
    zero4(acc);
    zero4(accs);
    stage(b0, Bm + bcrow + nc, (size_t)G * N, nrow, N - nc, false);  // [s][n]
    __syncthreads();
    mm(acc, [&](int i, int k) { return Qm[i * kLds + k]; }, b0, ty, tx);
    for (int pc = 0; pc < P; pc += kC) {
      __syncthreads();
      stage(b1, dy + xrow + pc, (size_t)H * P, nrow, P - pc, false);  // [t][p]
      stage(b2, Ht + (size_t)pc * NP + nc, (size_t)NP, P - pc, N - nc, false);  // h [p][n]
      __syncthreads();
      mm(accs, [&](int i, int k) { return b1[i * kLds + k]; }, b2, ty, tx);
      for (int i = t; i < kC * kC; i += kThreads) {
        const int p = i / kC, n = i % kC;
        if (pc + p < P && nc + n < N)
          ghp += b2[p * kLds + n] * Gt[(size_t)(pc + p) * N + nc + n];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = ty + 16 * i;
      if (tt >= nrow) continue;
      float* o = w.dch + ((size_t)(bi * S + t0 + tt) * H + hi) * N;
      const float* cr = Cm + bcrow + (size_t)tt * G * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + tx + 16 * j;
        if (n >= N) continue;
        o[n] = acc[i][j] + ecs[tt] * accs[i][j];
        rc[i] += cr[n] * accs[i][j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) pcs[(ty + 16 * i) * 16 + tx] = rc[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ghp += __shfl_xor_sync(0xffffffffu, ghp, o);
  if (t % 32 == 0) gh[t / 32] = ghp;
  __syncthreads();
  // the partials of each step, added in index order by one thread
  if (t < kL) {
    float sx = 0.f, sz = 0.f, sc = 0.f;
    for (int k = 0; k < 16; ++k) {
      sx += px[t * 16 + k];
      sz += pz[t * 16 + k];
      sc += pcs[t * 16 + k];
    }
    dux[t] = sx;
    zs[t] = sz * dts[t] * wdec[t];
    dcs[t] += ecs[t] * sc;
  }
  __syncthreads();

  // ---- the decay gradient: state terms, the reverse cumsum into da, then
  // ddt = A da + <du, x> and this tile's share of dA = sum dt da ----
  if (t < 32) {
    const int lane = t;
    float z2 = zs[2 * lane] + zs[2 * lane + 1];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z2 += __shfl_xor_sync(0xffffffffu, z2, o);
    // dcs_s -= z_s; dcs_last += sum_s z_s + E <G, h_prev>
    float d0 = dcs[2 * lane] - zs[2 * lane];
    float d1 = dcs[2 * lane + 1] - zs[2 * lane + 1];
    if (lane == 31) {
      float ght = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) ght += gh[k];
      d1 += z2 + expf(cs[kL - 1]) * ght;
    }
    // da_k = sum_{t >= k} dcs_t: a suffix scan, lane 31 holds the end
    float inc = d0 + d1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, inc, o);
      if (lane + o < 32) inc += u;
    }
    float excl = __shfl_down_sync(0xffffffffu, inc, 1);
    if (lane == 31) excl = 0.f;
    const float da1 = excl + d1, da0 = da1 + d0;
    float part = dts[2 * lane] * da0 + dts[2 * lane + 1] * da1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    const float da[2] = {da0, da1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = 2 * lane + k;
      if (s < nrow)
        ddt[(size_t)(bi * S + t0 + s) * H + hi] = a * da[k] + dux[s];
    }
    if (lane == 0) w.dap[(size_t)row * T + tile] = part;
  }
}

// Launch 4: dB, dC = the heads' sums over each group; dA = the tiles' sum.
constexpr int kSumThreads = 256;
__global__ void __launch_bounds__(kSumThreads) ssd_bwd_sum_kernel(
    float* __restrict__ bws, float* __restrict__ dB, float* __restrict__ dC,
    float* __restrict__ dA, int batch, int S, int H, int P, int G, int N,
    int T) {
  const Bws w = bws_parts(bws, batch, S, H, P, N, T);
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  const int rep = H / G;
  if (i < (size_t)batch * H) {
    float s = 0.f;
    for (int c = 0; c < T; ++c) s += w.dap[i * T + c];
    dA[i] = s;
  }
  if (i >= (size_t)batch * S * G * N) return;
  const int n = (int)(i % N);
  const size_t bsg = i / N;  // (b * S + s) * G + g
  const int g = (int)(bsg % G);
  const size_t bs = bsg / G;
  const size_t base = (bs * H + (size_t)g * rep) * N + n;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    sb += w.dbh[base + (size_t)r * N];
    sc += w.dch[base + (size_t)r * N];
  }
  dB[i] = sb;
  dC[i] = sc;
}

template <typename TX>
int launch_typed(const void* xv, const float* dt, const float* A,
                 const float* B, const float* C, const float* fws,
                 const void* dyv, const float* dstate, void* dxv, float* ddt,
                 float* dA, float* dB, float* dC, float* bws, int batch,
                 int S, int H, int P, int G, int N, cudaStream_t st) {
  const TX* x = static_cast<const TX*>(xv);
  const TX* dy = static_cast<const TX*>(dyv);
  TX* dx = static_cast<TX*>(dxv);
  const int T = (S + kL - 1) / kL;
  const Fws fw = fws_parts(fws, batch, H, G, P, np_of(N), T);
  cudaError_t e;
  if (T > 0) {
    auto k1 = ssd_bwd_carry_kernel<TX>;
    const size_t s1 = (2 * kChunk + 3 * kL) * sizeof(float);
    e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s1);
    if (e != cudaSuccess) return (int)e;
    k1<<<dim3(T, batch * H), kThreads, s1, st>>>(dy, dt, A, C, bws, batch, S,
                                                  H, P, G, N, T);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ssd_bwd_pass_kernel<<<dim3((P * N + kPassThreads - 1) / kPassThreads,
                               batch * H),
                          kPassThreads, 0, st>>>(fw.el, dstate, bws, batch, S,
                                                 H, P, N, T);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    auto k3 = ssd_bwd_tile_kernel<TX>;
    const size_t s3 = TileLayout::kFloats * sizeof(float);
    e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s3);
    if (e != cudaSuccess) return (int)e;
    k3<<<dim3(T, batch * H), kThreads, s3, st>>>(x, dt, A, B, C, fws, dy, dx,
                                                  ddt, bws, batch, S, H, P, G,
                                                  N, T);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t work = (size_t)batch * S * G * N > (size_t)batch * H
                          ? (size_t)batch * S * G * N
                          : (size_t)batch * H;
  ssd_bwd_sum_kernel<<<(unsigned)((work + kSumThreads - 1) / kSumThreads),
                       kSumThreads, 0, st>>>(bws, dB, dC, dA, batch, S, H, P,
                                             G, N, T);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the workspace ssd_scan_bwd_launch needs for these shapes.
extern "C" long long ssd_scan_bwd_workspace(int batch, int S, int H, int P,
                                            int G, int N) {
  if (N < 1 || N > kMaxN) return -1;
  const long long T = (S + kL - 1) / kL;
  return (long long)batch * H * T * P * N + 2LL * batch * S * H * N +
         (long long)batch * H * T;
}

// Model layout, as ssd_scan_launch: x, dy, dx (batch, S, H, P) in x_dtype
// (0 f32, 1 bf16); dt, ddt (batch, S, H); A, dA (batch, H); B, C, dB, dC
// (batch, S, G, N); dstate (batch, H, P, N), the gradient into the final
// state; fws: the workspace the forward's ssd_scan_launch filled for the
// same inputs; bws: ssd_scan_bwd_workspace(...) floats. All f32 but x, dy
// and dx, contiguous. Four launches on `stream`; returns the first launch
// error.
extern "C" int ssd_scan_bwd_launch(const void* x, int x_dtype, const float* dt,
                                   const float* A, const float* B,
                                   const float* C, const float* fws,
                                   const void* dy, const float* dstate,
                                   void* dx, float* ddt, float* dA, float* dB,
                                   float* dC, float* bws, int batch, int S,
                                   int H, int P, int G, int N, void* stream) {
  if (N < 1 || N > kMaxN || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (batch * H == 0 || P == 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_typed<float>(x, dt, A, B, C, fws, dy, dstate, dx, ddt, dA,
                               dB, dC, bws, batch, S, H, P, G, N, st);
  return launch_typed<__nv_bfloat16>(x, dt, A, B, C, fws, dy, dstate, dx, ddt,
                                     dA, dB, dC, bws, batch, S, H, P, G, N,
                                     st);
}
