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
// 256 tokens, 32 heads, hp 64, n 128) the chunked algorithm does ~1 GFLOP
// of f32 products on ~5 MB, so it is bound by operations. The design:
//   * The TPU kernel holds a whole (Q, n) B/C tile and the (Q, Q) C.B^T
//     tile in VMEM; at Q = 256, n = 128 those are 128 KB and 256 KB, past a
//     block's 227 KB. Here a tile is 64 steps: B and C (64 x n, stored
//     transposed for conflict-free float4 reads), the 64 x 64 decayed
//     C.B^T product and a 64 x 16 slice of x fit in ~100 KB, two blocks per
//     SM.
//   * The TPU grid is (rows, chunks) run in order on one core. Rows of the
//     state are independent (y[:, p] reads only state[p, :] and x[:, p]), so
//     a block here owns one (batch, head) row and 16 of its hp columns, and
//     walks the tiles in order with its (16, n) slice of the state in
//     registers: a batch-1 prompt has 32 x 4 = 128 blocks for 132 SMs.
//   * B and C are shared by the heads of a group: the kernel reads them at
//     head / (H / G) and never builds the repeated copies the JAX wrapper
//     makes.
//   * C.B^T is computed only on the 136 lower-triangular 4 x 4 tiles of the
//     64 x 64 product, packed onto the first 136 threads.
// f32 FMAs throughout; sharing C.B^T across the heads of a group and tensor
// cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;                    // time steps per tile
constexpr int kLP = kL + 4;               // padded row of the transposed tiles
constexpr int kPB = 16;                   // hp columns per block
constexpr int kKLanes = kThreads / kPB;   // 16 lanes down the state dim n
constexpr int kTri = (kL / 4) * (kL / 4 + 1) / 2;  // 136 lower 4x4 tiles
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

__host__ __device__ constexpr int smem_floats(int n) {
  // Bt, Ct [n][kLP]; Gt [kL][kLP]; Xs [kL][kPB]; St [n][kPB]; cs, dts, wdec
  return 2 * n * kLP + kL * kLP + kL * kPB + n * kPB + 3 * kL;
}

// KPT: state entries per thread (n <= 16 * KPT).
template <typename TX, int KPT>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, TX* __restrict__ y,
    float* __restrict__ state_out, int S, int H, int P, int G, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Bt = smem;              // Bt[k][s] = B_s[k]
  float* Ct = Bt + N * kLP;      // Ct[k][q] = C_q[k]
  float* Gt = Ct + N * kLP;      // Gt[s][q] = (C_q.B_s) exp(cs_q - cs_s) dt_s
  float* Xs = Gt + kL * kLP;     // Xs[s][j] = x_s[p0 + j]
  float* St = Xs + kL * kPB;     // St[k][j] = state[p0 + j][k] at tile start
  float* cs = St + N * kPB;      // inclusive running sum of dt * A
  float* dts = cs + kL;
  float* wdec = dts + kL;        // exp(cs_last - cs_s) dt_s
  __shared__ float s_last;

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * kPB;
  const int row = blockIdx.y;    // batch * H + head
  const int bi = row / H, hi = row % H;
  const int gi = hi / (H / G);
  const float a = A[row];

  const int pj = t % kPB;        // this thread's state column
  const int kg = t / kPB;        // and its lane down n: k = kg + kKLanes * i
  float st[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) st[i] = 0.f;
  for (int i = t; i < N * kPB; i += kThreads) St[i] = 0.f;

  // this thread's lower-triangular 4x4 tile of the C.B^T product
  int ti = 0, tj = 0;
  if (t < kTri) {
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    tj = t - ti * (ti + 1) / 2;
  }

  for (int t0 = 0; t0 < S; t0 += kL) {
    // 1. stage the tile: B and C transposed, x's column slice, dt
    for (int i = t; i < kL * N; i += kThreads) {
      const int s = i / N, k = i % N, ts = t0 + s;
      float bv = 0.f, cv = 0.f;
      if (ts < S) {
        const size_t off = ((size_t)(bi * S + ts) * G + gi) * N + k;
        bv = Bm[off];
        cv = Cm[off];
      }
      Bt[k * kLP + s] = bv;
      Ct[k * kLP + s] = cv;
    }
    for (int i = t; i < kL * kPB; i += kThreads) {
      const int s = i / kPB, pc = p0 + i % kPB, ts = t0 + s;
      Xs[i] = (ts < S && pc < P)
                  ? to_f32(x[((size_t)(bi * S + ts) * H + hi) * P + pc])
                  : 0.f;
    }
    if (t < kL)
      dts[t] = t0 + t < S ? dt[(size_t)(bi * S + t0 + t) * H + hi] : 0.f;
    __syncthreads();

    // 2. running sum of dt * A over the tile: one warp, two steps a lane
    if (t < 32) {
      const float v0 = dts[2 * t] * a, v1 = dts[2 * t + 1] * a;
      float inc = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (t >= o) inc += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (t == 0) excl = 0.f;
      const float c0 = excl + v0, c1 = c0 + v1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cs[2 * t] = c0;
      cs[2 * t + 1] = c1;
      wdec[2 * t] = expf(last - c0) * dts[2 * t];
      wdec[2 * t + 1] = expf(last - c1) * dts[2 * t + 1];
      if (t == 0) s_last = last;
    }
    __syncthreads();

    // 3. Gt on the lower-triangular 4x4 tiles (q = 4ti + r, s = 4tj + c)
    if (t < kTri) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < N; ++k) {
        const float4 c4 = *reinterpret_cast<const float4*>(Ct + k * kLP + 4 * ti);
        const float4 b4 = *reinterpret_cast<const float4*>(Bt + k * kLP + 4 * tj);
        const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
        const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cq[r], bs[c], acc[r][c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = 4 * tj + c;
        float o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = 4 * ti + r;
          o[r] = s <= q ? acc[r][c] * expf(cs[q] - cs[s]) * dts[s] : 0.f;
        }
        *reinterpret_cast<float4*>(Gt + s * kLP + 4 * ti) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // 4. y for rows q = 4 qg + r, column pj: the intra-tile sum over s <= q
    //    (Gt is zero above the diagonal inside the diagonal tile) plus the
    //    carried state at the tile's start
    {
      const int qg = t / kPB;
      float yd[4] = {0.f, 0.f, 0.f, 0.f}, yc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s <= 4 * qg + 3; ++s) {
        const float4 g4 = *reinterpret_cast<const float4*>(Gt + s * kLP + 4 * qg);
        const float xv = Xs[s * kPB + pj];
        yd[0] = fmaf(g4.x, xv, yd[0]);
        yd[1] = fmaf(g4.y, xv, yd[1]);
        yd[2] = fmaf(g4.z, xv, yd[2]);
        yd[3] = fmaf(g4.w, xv, yd[3]);
      }
      for (int k = 0; k < N; ++k) {
        const float4 c4 = *reinterpret_cast<const float4*>(Ct + k * kLP + 4 * qg);
        const float sv = St[k * kPB + pj];
        yc[0] = fmaf(c4.x, sv, yc[0]);
        yc[1] = fmaf(c4.y, sv, yc[1]);
        yc[2] = fmaf(c4.z, sv, yc[2]);
        yc[3] = fmaf(c4.w, sv, yc[3]);
      }
      const int pc = p0 + pj;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = 4 * qg + r, ts = t0 + q;
        if (ts < S && pc < P)
          store_as(y + ((size_t)(bi * S + ts) * H + hi) * P + pc,
                   yd[r] + expf(cs[q]) * yc[r]);
      }
    }

    // 5. state update in registers (reads Bt, Xs, wdec; St is untouched)
    {
      const float dec = expf(s_last);
#pragma unroll
      for (int i = 0; i < KPT; ++i) st[i] *= dec;
      for (int s = 0; s < kL; ++s) {
        const float xw = Xs[s * kPB + pj] * wdec[s];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int k = kg + kKLanes * i;
          if (k < N) st[i] = fmaf(xw, Bt[k * kLP + s], st[i]);
        }
      }
    }
    __syncthreads();  // every read of St, Bt, Ct, Xs of this tile is done
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int k = kg + kKLanes * i;
      if (k < N) St[k * kPB + pj] = st[i];
    }
    // the next tile's staging writes Bt, Ct, Xs and dts only, and syncs
    // before anything reads St again
  }

  const int pc = p0 + pj;
  if (pc < P) {
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int k = kg + kKLanes * i;
      if (k < N) state_out[((size_t)row * P + pc) * N + k] = st[i];
    }
  }
}

template <typename TX, int KPT>
int launch_typed(const void* x, const float* dt, const float* A,
                 const float* B, const float* C, void* y, float* state,
                 int batch, int S, int H, int P, int G, int N,
                 cudaStream_t st) {
  auto kern = ssd_scan_kernel<TX, KPT>;
  const size_t smem = (size_t)smem_floats(N) * sizeof(float);
  // The limit is per device, so it is raised on every launch (a cheap
  // call) to the largest n of this instantiation.
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(16 * KPT) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((P + kPB - 1) / kPB, batch * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const TX*>(x), dt, A, B, C, static_cast<TX*>(y), state, S,
      H, P, G, N);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_n(const void* x, const float* dt, const float* A, const float* B,
             const float* C, void* y, float* state, int batch, int S, int H,
             int P, int G, int N, cudaStream_t st) {
  if (N <= 16)
    return launch_typed<TX, 1>(x, dt, A, B, C, y, state, batch, S, H, P, G, N, st);
  if (N <= 32)
    return launch_typed<TX, 2>(x, dt, A, B, C, y, state, batch, S, H, P, G, N, st);
  if (N <= 64)
    return launch_typed<TX, 4>(x, dt, A, B, C, y, state, batch, S, H, P, G, N, st);
  if (N <= 128)
    return launch_typed<TX, 8>(x, dt, A, B, C, y, state, batch, S, H, P, G, N, st);
  return launch_typed<TX, 16>(x, dt, A, B, C, y, state, batch, S, H, P, G, N, st);
}

}  // namespace

// Model layout: x, y (batch, S, H, P) in x_dtype (0 f32, 1 bf16); dt
// (batch, S, H), A (batch, H), B, C (batch, S, G, N), state (batch, H, P, N),
// all f32 and contiguous. H a multiple of G, 1 <= N <= 256. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, int x_dtype, const float* dt,
                               const float* A, const float* B, const float* C,
                               void* y, float* state, int batch, int S, int H,
                               int P, int G, int N, void* stream) {
  if (N < 1 || N > kMaxN || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (batch * H == 0 || P == 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_n<float>(x, dt, A, B, C, y, state, batch, S, H, P, G, N, st);
  return launch_n<__nv_bfloat16>(x, dt, A, B, C, y, state, batch, S, H, P, G,
                                 N, st);
}
