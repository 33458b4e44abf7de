// Exact k-nearest (or k-farthest) rows of p for every row of q, k <= 128.
//
// Replaces the TPU kernel `topk_pallas` of sednet_tpu/ops/flash_topk.py
// (`_make_kernel`, `_dist_tile`, `_fold_tile`). Two metrics, written with
// the same expansion as `_dist_tile`:
//
//   sqdist:          d = |q|^2 + |p|^2 - 2 q.p
//   points_normals:  d = (|q3|^2 + |p3|^2 - 2 q3.p3) * (1 + w (2 - 2 qn.pn))
//                    (q3: channels 0-2, qn: channels 3-5)
//
// `largest` selects the k largest distances by selecting the k smallest of
// -d. The result is ascending in the selected order (nearest first, or
// farthest first), ties broken by the lower column index.
//
// Bound on the H100: operations. A layer-2 graph at B=8, N=10000, D=64 is
// 2*B*N*N*D = 1.0e11 flops of dot products, kept at float32 accuracy on
// the tensor cores by the three-term TF32 split (sim_tile.cuh): 0.62 ms at
// 495 TFLOP/s. At widths of 3 and 6 the distances cost almost nothing and
// the selection is the work: 8e8 candidates for the spectral farthest-50.
//
// Design: the column walk of knn_walk.cuh with its selection as the row
// action (per-row queues merged into lists in registers, knn_select.cuh;
// the distance tile on the tensor cores at D > 8, on the CUDA cores at
// D <= 8 and for points_normals; the variant, block size and column split
// chosen at launch). K4 (fused_edgeconv.cu) runs the same walk.
#include <cuda_runtime.h>

#include "knn_walk.cuh"

using knn_walk::Args;
using knn_walk::MAX_SPLIT;
using knn_walk::SMALL_D;
using knn_walk::SelectOut;
using knn_walk::TopkSelect;
using knn_walk::launch;

// q: (B, M, D) with batch stride q_bstride elements; p: (B, N, D) with batch
// stride p_bstride (0 shares one point set); metric 0 = sqdist,
// 1 = points_normals (D >= 6). col_ids: null, or (B, N) int32 with batch
// stride col_bstride (0 shares one table): the id each column is listed
// under and ordered by among equal values (a permutation of 0 .. N-1 for
// the spatial sort: the original index of a sorted column). out_d:
// (B, M, k) float32, out_i: (B, M, k) int32.
extern "C" int sednet_topk(const void* q, const void* p, long long q_bstride,
                           long long p_bstride, int batch, int m, int n,
                           int d, int k, int metric, float w, int largest,
                           const void* col_ids, long long col_bstride,
                           void* out_d, void* out_i, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool tensor = metric == 0 && d > SMALL_D;
  Args a;
  a.q = (const float*)q;
  a.p = (const float*)p;
  a.q_bstride = q_bstride;
  a.p_bstride = p_bstride;
  a.m = m;
  a.n = n;
  a.d = d;
  a.k = k;
  a.metric = metric;
  a.largest = largest;
  a.vec = (d & 3) == 0 && sim_tile::aligned16(q) && sim_tile::aligned16(p);
  a.w = w;
  a.col_ids = (const int*)col_ids;
  a.col_bstride = col_bstride;
  const SelectOut o = {(float*)out_d, (int*)out_i, nullptr, nullptr};
  if (k <= 32)
    return launch<TopkSelect, 1, true>(a, o, batch, tensor, MAX_SPLIT, false,
                                       st);
  if (k <= 64)
    return launch<TopkSelect, 2, true>(a, o, batch, tensor, MAX_SPLIT, false,
                                       st);
  return launch<TopkSelect, 4, true>(a, o, batch, tensor, MAX_SPLIT, false,
                                     st);
}
