// morph_matmul for Hopper: (B, M, K) @ (K, N) with per-batch active widths.
//
// Replaces the TPU kernel src/repro/kernels/morph_matmul.py:_kernel
// (pallas_call in _morph_matmul_core). The kernel body, its bound on the
// H100 and how the design meets it are described in gemv.cuh; this file is
// the plain C entry point that repro_torch/kernels/morph_matmul.py loads
// with ctypes.
#include "gemv.cuh"

extern "C" int morph_matmul_launch(const void* x, int x_dtype, const void* w,
                                   int w_dtype, void* out, int out_dtype,
                                   const int* active_n, const int* active_k,
                                   int B, int M, int K, int N, int round_w,
                                   int vec, int splits, int k_per_split,
                                   float* ws, int* tickets, void* stream) {
  rt::GemvArgs a = {};
  a.x = x;
  a.ak = active_k;
  a.B = B;
  a.M = M;
  a.K = K;
  a.nseg = 1;
  a.seg[0].w = w;
  a.seg[0].out = out;
  a.seg[0].an = active_n;
  a.seg[0].N = N;
  a.splits = splits;
  a.k_per_split = k_per_split;
  a.ws = ws;
  a.tickets = tickets;
  return rt::gemv_launch(a, x_dtype, w_dtype, out_dtype, vec != 0,
                         round_w != 0, static_cast<cudaStream_t>(stream));
}
