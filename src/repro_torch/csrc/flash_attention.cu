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
//
// Layout: q and out (B, Sq, H, hd) and k, v (B, Sk, KV, hd) addressed by
// element strides per (batch, position, head) with hd contiguous, so one
// kernel serves the model layout and the reference's flat (BH, S, hd)
// layout (there B = BKV, H = group, KV = 1, and query row bh reads KV row
// bh / group). KV head of query head h: h / (H / KV).
//
// What bounds it on the H100: at the TinyLlama prompt pass (1 x 256 tokens,
// 32 query heads of 64, 4 KV heads, causal) the work is ~0.27 GFLOP of
// products on ~2.4 MB of bf16: bytes bound it at the tensor cores' rate
// (0.7 us to move the bytes, 0.3 us for the products), but this kernel's
// f32 FMAs (67 TFLOP/s) need at least 4 us, so its own arithmetic is the
// limit until it uses tensor cores. The design is the simple one first:
//   * one block of 128 threads per (query head row, 64-row query tile):
//     128 blocks at the prompt shape for 132 SMs;
//   * the query tile, each key tile (both stored transposed, padded rows)
//     and each value tile are staged in shared memory as f32 (bf16 is cast
//     on load); a thread owns 4 query rows x 8 key columns of the 64 x 64
//     score tile and 4 rows x hd/8 columns of the accumulator, so the row
//     statistics are shared by 8 neighbouring lanes (shuffles, no shared
//     memory); p goes through shared memory to the P.V product;
//   * p stays in f32 for P.V, as in the TPU kernel.
// f32 FMAs throughout. Tensor cores (mma.sync / wgmma), TMA, double
// buffering and one key tile shared by the heads of a group are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // key rows per tile
constexpr int kTP = kBK + 1;        // padded row of the transposed q / k tiles
constexpr int kPP = kBK + 2;        // padded row of the probabilities
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kMaxHD = 128;
constexpr int kU = 8;               // loads in flight per thread when staging

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ constexpr int smem_floats(int hd) {
  // Qt [hd][kTP], Kt [hd][kTP], Vs [kBK][hd], Ps [kBQ][kPP]
  return 2 * hd * kTP + kBK * hd + kBQ * kPP;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qss, qsh;   // q and o strides (batch, position, head)
  long long ksb, kss, ksh;   // k and v strides
  int H, KV, Sq, Sk, hd, causal, window;
  float scale;
};

// HD: hd rounded up to a multiple of 8 (the accumulator's columns).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(Args a) {
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
  const T* __restrict__ q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* __restrict__ k = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* __restrict__ v = static_cast<const T*>(a.v) + b * a.ksb + kvh * a.ksh;
  T* o = static_cast<T*>(a.o) + b * a.qsb + h * a.qsh;

  // staging: kU independent loads per thread are issued before their
  // stores, so a tile costs a few memory latencies, not one per element
  for (int base = 0; base < kBQ * hd; base += kU * kThreads) {
    float x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads + t, r = i / hd, d = i % hd;
      x[u] = i < kBQ * hd && q0 + r < a.Sq ? to_f32(q[(q0 + r) * a.qss + d])
                                           : 0.f;
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
        kx[u] = in ? to_f32(k[off]) : 0.f;
        vx[u] = in ? to_f32(v[off]) : 0.f;
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
        // one -1e30 however many conditions mask the column, as the TPU
        // kernel's where() chain builds it
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
      if (d < hd) store_as(o + row * a.qss + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
int launch_typed(const Args& a, int B, cudaStream_t st) {
  auto kern = flash_attn_kernel<T, HD>;
  const size_t smem = (size_t)smem_floats(a.hd) * sizeof(float);
  // The limit is per device, so it is raised on every launch (a cheap
  // call) to the largest hd of this instantiation.
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(HD) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.H);
  kern<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Args& a, int B, cudaStream_t st) {
  if (a.hd <= 32) return launch_typed<T, 32>(a, B, st);
  if (a.hd <= 64) return launch_typed<T, 64>(a, B, st);
  return launch_typed<T, kMaxHD>(a, B, st);
}

}  // namespace

// q, out: (B, Sq, H, hd) at element strides (qsb, qss, qsh); k, v:
// (B, Sk, KV, hd) at (ksb, kss, ksh); hd contiguous everywhere; dtype 0 f32,
// 1 bf16 for all four. H a multiple of KV, 1 <= hd <= 128, window 0 for
// none. Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int KV, int Sq, int Sk, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, int causal,
    int window, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHD || KV < 1 || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  Args a{q, k, v, out, qsb, qss, qsh, ksb, kss, ksh,
         H, KV, Sq, Sk, hd, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_hd<float>(a, B, st);
  return launch_hd<__nv_bfloat16>(a, B, st);
}
