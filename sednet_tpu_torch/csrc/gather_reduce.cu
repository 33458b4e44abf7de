// Neighbour gather of a feature table, reduced over the K neighbours.
//
// Replaces the TPU kernel `_call` of scripts/probe_gather_pallas.py (the
// in-VMEM gather that never lowered on Mosaic; the JAX package computes the
// same thing with XLA's flat gather, sednet_tpu/ops/graph.py:118-121). For
// every shape b and row i, with j_k = clamp(idx[b, i, k], 0, N - 1):
//
//   s[b, i, :]  = sum_k a[b, j_k, :]           (k ascending)
//   sq[b, i, :] = sum_k a[b, j_k, :]^2
//   mx[b, i, :] = max_k a[b, j_k, :]           (from -inf)
//
// These are the three reductions of the factored edge convolution
// (ops/graph.py edge_conv_factored); the (B, N, K, C) gathered tensor of the
// plain version never exists.
//
// Bound on the H100: bytes. The unique traffic is the table (B*N*C floats),
// the int64 indices (B*N*K) and the three outputs: 123 MB at B=8, N=10000,
// K=64, C=64, 0.04 ms at 3.35 TB/s. The row reads themselves are K times
// the table (1.31 GB at C=64, 2.62 GB at C=128), but one shape's table is
// 2.56-5.12 MB and the whole batch's 20-41 MB fits the 50 MB L2, so they
// come from L2, not HBM: what the TPU design wanted from VMEM.
//
// Design: the warp-a-row loop of gather_rows.cuh (also K4's phase 2) on
// int64 indices.
#include <cuda_runtime.h>

#include "gather_rows.cuh"

// a: (B, N, C) float32, C a multiple of 32 up to 256, 16-byte aligned;
// idx: (B, N, K) int64, 1 <= K <= 128 (out-of-range entries clamp into
// [0, N)); s, sq, mx: (B, N, C) float32. One launch on `stream`, no
// synchronisation.
extern "C" int sednet_gather_reduce(const void* a, const void* idx, int batch,
                                    int n, int c, int k, void* s, void* sq,
                                    void* mx, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > gather_rows::KMAX || c < 32 ||
      c > 256 || c % 32 != 0)
    return (int)cudaErrorInvalidValue;
  return gather_rows::launch<long long>(
      (const float*)a, (const long long*)idx, batch, n, c, k, (float*)s,
      (float*)sq, (float*)mx, nullptr, (cudaStream_t)stream);
}
