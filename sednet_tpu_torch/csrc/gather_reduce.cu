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
// What bounds it on the H100. The unique traffic is the table (B*N*C
// floats), the int64 indices (B*N*K), the int32 order (B*N) and the three
// outputs: 123 MB at B=8, N=10000, K=64, C=64, 0.037 ms at 3.35 TB/s. The
// row reads are K times the table (1.31 GB at C=64, 2.62 GB at C=128), and
// a batch's table (20-41 MB) fits the 50 MB L2, so the first design (a warp
// a row, 8 rows a block in the cloud's order) was taken to run at L2's
// rate. Measured (scripts/bench_gather.py), it did not: on a graph where
// every block's rows read the same 64 rows, all from L1, that loop took as
// long as on the real graphs. It was bound by its own instructions: a
// 64-bit shuffle and address for every neighbour row and two channels a
// lane at C=64, against four float operations a channel that must stay as
// they are (each channel summed in k order, no FMA, so the bits of every
// earlier version).
//
// Design. The loop in gather_rows.cuh (also K4's phase 2) gives each lane a
// float4 of channels (C/4 lanes a row: two rows a warp at C=64), keeps the
// neighbours as 32-bit offsets (one shuffle a neighbour), and loads eight
// neighbour rows ahead of their adds. Its blocks walk runs of 32
// consecutive rows along a Morton curve of the points (ops/graph.py
// locality_order), on which a block's rows share most of their neighbours
// (a run of 64 rows reads a tenth as many distinct rows as it reads), so
// L1 serves most reads (PERF.md gives both loops' times under both
// orders). Every row is computed as before (its K neighbours in ascending
// order, one owner a channel, no atomics), so the outputs are the same bits
// under every order.
#include <cuda_runtime.h>

#include "gather_rows.cuh"

// a: (B, N, C) float32, C a multiple of 32 up to 256, N C < 2^32, 16-byte
// aligned; idx: (B, N, K) int64, 1 <= K <= 128 (out-of-range entries clamp into
// [0, N)); order: (B, N) int32, a permutation of each shape's rows, or null
// for the identity; s, sq, mx: (B, N, C) float32. One launch on `stream`,
// no synchronisation.
extern "C" int sednet_gather_reduce(const void* a, const void* idx,
                                    const void* order, int batch, int n,
                                    int c, int k, void* s, void* sq, void* mx,
                                    void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > gather_rows::KMAX || c < 32 ||
      c > 256 || c % 32 != 0)
    return (int)cudaErrorInvalidValue;
  return gather_rows::launch<long long>(
      (const float*)a, (const long long*)idx, (const int*)order, batch, n, c,
      k, (float*)s, (float*)sq, (float*)mx, nullptr, (cudaStream_t)stream);
}
