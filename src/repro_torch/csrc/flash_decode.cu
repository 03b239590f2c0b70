// Single-token GQA attention over a float or int8 KV cache, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:_kernel
// (pallas_call in flash_decode). For each query head row bh it computes
// softmax(q k^T / sqrt(hd)) v over the cache positions < kv_len of KV row
// bh / group; an int8 cache carries per-row scales. kv_len is read from
// device memory (the counterpart of the TPU kernel's scalar prefetch), so
// one build serves every length without a host sync, and cache rows at or
// past it are never read. With kv_len = 0 every row is skipped and the
// output is 0, as the TPU kernel's (acc 0 over l clamped to 1e-20).
//
// The kernel is the shared decode-attention core (decode_attn.cuh, where
// its bound on the H100 and its design are described): one unit per KV
// row, whose `group` query heads read each cache row once per launch (the
// TPU grid streams a cache row once per query head); the rows of a KV row
// split over one thread block cluster and merged through distributed shared
// memory. bf16 and int8 caches run on the tensor cores (f32 queries split
// into two bf16 halves), f32 caches on f32 FMAs. This file supplies the
// problem: the contiguous (BKV, S, hd) layout, kv_len, and the output in
// q's dtype.
#include "decode_attn.cuh"

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_any(const void* p, int dtype, size_t i) {
  return dtype == kF32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

template <bool QUANT>
struct FlashDecodeProb {
  // the core's interface (decode_attn.cuh)
  int units, hgroups, G, hd, rps, vec;
  float scale;
  const void* kc;
  const void* vc;
  static constexpr bool kQuant = QUANT;
  static constexpr bool kExt = false;
  static constexpr bool kRowMask = false;
  static constexpr int kMTiles = 1;
  int ext_floats() const { return 0; }
  // this problem
  const void* q;        // (BKV * G, hd), q_dt
  void* out;            // (BKV * G, hd), q_dt
  const void* ks;       // (BKV, S, 1) int8 caches only, scale_dt
  const void* vs;
  const int* kv_len;    // device scalar, or null: use kv_len_host
  int kv_len_host, S, q_dt, scale_dt;
  int r, h0;            // this block: KV row, first head

  __device__ int begin(int unit, int h0_, int) {
    r = unit;
    h0 = h0_;
    return min(max(kv_len ? *kv_len : kv_len_host, 0), S);
  }
  __device__ bool ok(int) const { return true; }
  __device__ size_t row(int jj) const { return ((size_t)r * S + jj) * hd; }
  __device__ float kscale(int jj) const {
    return load_any(ks, scale_dt, (size_t)r * S + jj);
  }
  __device__ float vscale(int jj) const {
    return load_any(vs, scale_dt, (size_t)r * S + jj);
  }
  template <int HDP, int MR>
  __device__ void load_q(float* qs, int ldq, float*, int t) const {
    constexpr int N = MR * HDP / da::kThreads;
    const int nh = min(MR, G - h0);
    const size_t base = ((size_t)r * G + h0) * hd;
    float x[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = t + u * da::kThreads, h = i / HDP, d = i % HDP;
      x[u] = h < nh && d < hd ? load_any(q, q_dt, base + (size_t)h * hd + d)
                              : 0.f;
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = t + u * da::kThreads;
      qs[(i / HDP) * ldq + i % HDP] = x[u];
    }
  }
  template <int HDP, int MR>
  __device__ void prepare(float*, int, float*, int) const {}
  __device__ void store(int h, int d, float v) const {
    const size_t i = ((size_t)r * G + h0 + h) * hd + d;
    if (q_dt == kF32)
      static_cast<float*>(out)[i] = v;
    else
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  }
  __device__ void after_merge(float*, int, int, int) const {}
};

template <bool QUANT>
FlashDecodeProb<QUANT> make_prob(const void* q, int q_dtype, const void* k,
                                 const void* v, const void* ks, const void* vs,
                                 int scale_dtype, const int* kv_len,
                                 int kv_len_host, void* out, int BKV, int G,
                                 int S, int hd, int rows_per_split,
                                 float scale, int esize) {
  FlashDecodeProb<QUANT> p = {};
  p.units = BKV;
  p.hgroups = (G + da::kMaxHeads - 1) / da::kMaxHeads;
  p.G = G;
  p.hd = hd;
  p.rps = rows_per_split;
  p.vec = (hd * esize) % 16 == 0 && da::aligned16(k) && da::aligned16(v);
  p.scale = scale;
  p.kc = k;
  p.vc = v;
  p.q = q;
  p.out = out;
  p.ks = ks;
  p.vs = vs;
  p.kv_len = kv_len;
  p.kv_len_host = kv_len_host;
  p.S = S;
  p.q_dt = q_dtype;
  p.scale_dt = scale_dtype;
  return p;
}

// Calls f(problem, (TC*)nullptr, std::integral_constant<bool, QSPLIT>())
// for the route the cache's dtype takes: bf16 / int8 on the tensor cores
// (f32 q split into hi + lo), f32 on FMAs.
template <class F>
int with_route(const void* q, int q_dtype, const void* k, const void* v,
               int cache_dtype, const void* ks, const void* vs,
               int scale_dtype, const int* kv_len, int kv_len_host, void* out,
               int BKV, int G, int S, int hd, int rows_per_split, float scale,
               F&& f) {
  const bool qsplit = q_dtype == kF32;
  const std::true_type split;
  const std::false_type exact;
  if (cache_dtype == da::kI8) {
    auto p = make_prob<true>(q, q_dtype, k, v, ks, vs, scale_dtype, kv_len,
                             kv_len_host, out, BKV, G, S, hd, rows_per_split,
                             scale, 1);
    const int8_t* tc = nullptr;
    return qsplit ? f(p, tc, split) : f(p, tc, exact);
  }
  auto p = make_prob<false>(q, q_dtype, k, v, ks, vs, scale_dtype, kv_len,
                            kv_len_host, out, BKV, G, S, hd, rows_per_split,
                            scale, cache_dtype == da::kF32 ? 4 : 2);
  if (cache_dtype == da::kF32) return f(p, (const float*)nullptr, exact);
  const __nv_bfloat16* tc = nullptr;
  return qsplit ? f(p, tc, split) : f(p, tc, exact);
}

// the core, or with max_clusters set its occupancy query
int dispatch(const void* q, int q_dtype, const void* k, const void* v,
             int cache_dtype, const void* ks, const void* vs, int scale_dtype,
             const int* kv_len, int kv_len_host, void* out, int BKV, int G,
             int S, int hd, int splits, int rows_per_split, float scale,
             cudaStream_t st, int* max_clusters, int* route) {
  return with_route(
      q, q_dtype, k, v, cache_dtype, ks, vs, scale_dtype, kv_len, kv_len_host,
      out, BKV, G, S, hd, rows_per_split, scale,
      [&](const auto& p, auto tc, auto qsplit) {
        using TC = std::remove_const_t<std::remove_pointer_t<decltype(tc)>>;
        return da::launch_hd<std::decay_t<decltype(p)>, TC, decltype(qsplit)::value>(
            p, splits, st, max_clusters, route);
      });
}

// Probes of what a launch of the core costs before its work, at the same
// grid, clusters and shared memory: an empty kernel, and the core's chain
// of dependent steps without its work (the block's length read from device
// memory, then one dependent load of its first cache row, then the merge's
// two cluster barriers).
__global__ void decode_attn_empty() {}

template <class P, typename TC>
__global__ void __launch_bounds__(da::kThreads) decode_attn_skeleton(const P prm) {
  P pb = prm;
  const int hg = (int)blockIdx.x % pb.hgroups;
  const int h0 = hg * da::kMaxHeads;
  const int n = pb.begin((int)blockIdx.x / pb.hgroups, h0,
                         min(da::kMaxHeads, pb.G - h0));
  const int r = (int)blockIdx.y * pb.rps;
  float x = 0.f;
  if (threadIdx.x == 0 && r < n)
    x = (float)static_cast<const TC*>(pb.kc)[pb.row(r)];
  ptx::cluster_sync();
  if (x != x) pb.store(0, 0, x);  // never for a finite cache: keeps the load
  ptx::cluster_sync_relaxed();
}

template <class P, typename TC>
int launch_probe(const P& pb, int splits, cudaStream_t st, int skeleton) {
  return da::with_hdp(pb.hd, [&](auto hdp) {
    void* kern = skeleton ? (void*)decode_attn_skeleton<P, TC>
                          : (void*)decode_attn_empty;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int err = da::core_config<P, TC, decltype(hdp)::value>(kern, pb, splits,
                                                            st, false, cfg, attr);
    if (err) return err;
    if (pb.units * pb.hgroups == 0) return (int)cudaGetLastError();
    cudaError_t e = skeleton
                        ? cudaLaunchKernelEx(&cfg, decode_attn_skeleton<P, TC>, pb)
                        : cudaLaunchKernelEx(&cfg, decode_attn_empty);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  });
}

}  // namespace

// q, out: (BKV * G, hd) in q_dtype (0 f32, 1 bf16); k, v: (BKV, S, hd) in
// cache_dtype (0 f32, 1 bf16, 2 int8); ks, vs: (BKV, S, 1) in scale_dtype
// (int8 caches only); kv_len: an int32 on the device, or null for
// kv_len_host. Rows [sp * rows_per_split, (sp + 1) * rows_per_split) go to
// split sp, the splits of a KV row forming one cluster (1 <= splits <= 16);
// rows_per_split a multiple of 64. Launches on `stream`, writes the route
// of the kernel launched (0 f32 FMAs, 1 tensor cores) to *route and returns
// the launch's error code.
extern "C" int flash_decode_launch(
    const void* q, int q_dtype, const void* k, const void* v, int cache_dtype,
    const void* ks, const void* vs, int scale_dtype, const int* kv_len,
    int kv_len_host, void* out, int BKV, int G, int S, int hd, int splits,
    int rows_per_split, float scale, int* route, void* stream) {
  if (G < 1 || hd < 1 || hd > da::kMaxHD ||
      (long long)splits * rows_per_split < S)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, q_dtype, k, v, cache_dtype, ks, vs, scale_dtype, kv_len,
                  kv_len_host, out, BKV, G, S, hd, splits, rows_per_split,
                  scale, static_cast<cudaStream_t>(stream), nullptr, route);
}

// A probe of a timer's floor at the grid, clusters and shared memory that
// flash_decode_launch takes for the same arguments: skeleton = 0 an empty
// kernel, 1 the kernel's skeleton (its length read, one dependent row load,
// the merge's two cluster barriers). Writes nothing for a finite cache.
extern "C" int flash_decode_probe(
    const void* q, int q_dtype, const void* k, const void* v, int cache_dtype,
    const void* ks, const void* vs, int scale_dtype, const int* kv_len,
    int kv_len_host, void* out, int BKV, int G, int S, int hd, int splits,
    int rows_per_split, int skeleton, void* stream) {
  if (G < 1 || hd < 1 || hd > da::kMaxHD ||
      (long long)splits * rows_per_split < S)
    return (int)cudaErrorInvalidValue;
  return with_route(
      q, q_dtype, k, v, cache_dtype, ks, vs, scale_dtype, kv_len, kv_len_host,
      out, BKV, G, S, hd, rows_per_split, 1.f,
      [&](const auto& p, auto tc, auto) {
        using TC = std::remove_const_t<std::remove_pointer_t<decltype(tc)>>;
        return launch_probe<std::decay_t<decltype(p)>, TC>(
            p, splits, static_cast<cudaStream_t>(stream), skeleton);
      });
}

// How many clusters of `splits` blocks of the kernel a launch with these
// dtypes and hd would take fit on the card at once; written to *out.
extern "C" int flash_decode_max_clusters(int q_dtype, int cache_dtype, int hd,
                                         int splits, int* out) {
  if (hd < 1 || hd > da::kMaxHD) return (int)cudaErrorInvalidValue;
  return dispatch(nullptr, q_dtype, nullptr, nullptr, cache_dtype, nullptr,
                  nullptr, 0, nullptr, 0, nullptr, 1, 1, 1, hd, splits,
                  da::kChunk, 1.f, nullptr, out, nullptr);
}
