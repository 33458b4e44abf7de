// Index-free neighbour-set reductions of the fused DGCNN edge convolution.
//
// Replaces the TPU kernel `_make_fused_kernel` (fused_edge_reductions) of
// sednet_tpu/ops/fused_edgeconv.py. For every row i of geom (N, D) of one
// shape:
//
//   T_i  = the k-th smallest distance d(i, j) over j (self included), with
//          the expansion of `_dist_tile` (K1's, flash_topk.cu):
//            sqdist:          |q|^2 + |p|^2 - 2 q.p
//            points_normals:  (|q3|^2 + |p3|^2 - 2 q3.p3) * (1 + w (2 - 2 qn.pn))
//   S_i  = { j : d(i, j) <= T_i }   (every tie with the k-th distance joins)
//   mx_i = max_{j in S_i} a[j, :],  sm_i = sum a[j, :],  sq_i = sum a[j, :]^2,
//   cnt_i = |S_i|
//
// Bound on the H100: operations, one pass over the N x N distances of every
// shape. At D > 8 the dot products run on the tensor cores by the three-term
// TF32 split: 3 x 2*B*N*N*D flops at 495 TFLOP/s, 0.62 ms at B=8, N=10000,
// D=64 (1.58 ms for the same work on the f32 CUDA cores). At D <= 8 and for
// points_normals they run in f32 on the CUDA cores. Inputs and outputs are a
// few tens of MB; the gathered rows of `a` (B*N*k*C floats) come from L2.
//
// Design. S_i is row i's list of its k best columns by (value, column), as
// K1 selects them, plus the columns outside the list whose distance equals
// T_i exactly; the list holds the ties of lowest column, so those are the
// columns past the list's last one with d == T_i. Three launches:
//
//   phase 1: K1's column walk and selection (knn_walk.cuh, with TIES), on
//     the same variants and distance code: each row's k columns (int32
//     scratch), T_i, and a tie flag, set when a column outside the list
//     ties T_i. The flag needs no second pass: a column rejected at a ballot
//     or at a flush lies strictly above the final threshold, so the
//     selection keeps the least value it pushed out of each row's list (one
//     warp min a merge, in shared memory beside the threshold) and compares
//     it, with the list's entries past k, to T_i at the end.
//   phase 2: K6's warp-a-row loop (gather_rows.cuh) over the k columns, its
//     blocks on runs of the caller's row order (a Morton curve of the
//     points, so that L1 serves the repeated rows): the sum, sum of squares
//     and max of a's rows in list order, count k. On a row without a tie
//     the result is the index route's (K1's graph, then K6) bit for bit,
//     whatever the order.
//   phase 2b: flagged rows rescan every column with the same walk, so the
//     same distance bits phase 1 compared, and a row action (`Rescan`) that
//     adds each column with d == T_i past the list's last column to the
//     row's outputs. A block with no flagged row returns at once: on the
//     encoder's layers all but a few in 10000 rows (float coincidences and
//     duplicated points), on an integer grid few. So that the few blocks
//     that work stay short, a cluster of 8 blocks splits each row block's
//     columns; each sums its tied columns in shared memory and the cluster
//     adds the sums in rank order, with no atomics (see `Rescan`).
//
// The TPU kernel turned the mask into MXU products and a lane loop for the
// max because it has no cheap gather; here only the k listed rows are read.
#include <cuda_runtime.h>

#include "gather_rows.cuh"
#include "knn_walk.cuh"

namespace {

namespace cg = cooperative_groups;
using knn_walk::Args;
using knn_walk::FULL;
using knn_walk::MAX_SPLIT;
using knn_walk::RW;
using knn_walk::SMALL_D;
using knn_walk::SelectOut;
using knn_walk::TieSelect;
using knn_walk::launch;

constexpr int KMAX = 128;
constexpr int CMAX = 256;

// What the rescan reads (phase 1's columns, k-th values and flags; the
// table a (B, N, c)) and completes (phase 2's outputs).
struct RescanParams {
  const int* cols;
  const float* kth;
  const int* tie;
  const float* feat;
  int c;
  float* mx;
  float* sm;
  float* sq;
  float* cnt;
};

// Add the rows `hit` (bits over the tile's 32 columns from c0) of the table
// tab to one row's sums (in global or shared memory), column by column;
// every lane owns the channels lane, lane + 32, .. of the row, so it reads
// back only its own writes.
__device__ __noinline__ void add_tied(const float* tab, int c, unsigned hit,
                                      int c0, float* mx, float* sm,
                                      float* sq, float* cnt) {
  const int lane = threadIdx.x & 31;
  for (unsigned h = hit; h; h &= h - 1) {
    const float* src = tab + (size_t)(c0 + __ffs(h) - 1) * c;
    for (int ch = lane; ch < c; ch += 32) {
      const float x = src[ch];
      sm[ch] = sm[ch] + x;
      sq[ch] = sq[ch] + x * x;
      mx[ch] = fmaxf(mx[ch], x);
    }
  }
  if (lane == 0) *cnt += (float)__popc(hit);
}

// Phase 2b as a row action of the walk: a flagged row's columns past its
// list with d == T_i. Rescan clusters split the columns RSPLIT ways (most
// blocks return at once, so the few that work should be short). A block
// with at most G flagged rows sums each one's tied columns in shared
// memory, and the cluster's blocks add their sums to the row's outputs in
// rank order; a block with more (an integer grid) walks every column in
// its cluster's first block and adds them to the outputs as it finds them.
// Either way one order of addition, whatever the timing.
constexpr int G = 8;
constexpr int RSPLIT = 8;

template <int W, int KPL, int QPL>
struct Rescan {
  using Params = RescanParams;
  static constexpr int RB = RW * W;
  __host__ __device__ static constexpr int bytes() {
    return knn_walk::round16(RB * 12 + (G + 4) * 4 + G * (3 * CMAX + 1) * 4);
  }
  RescanParams p;
  int b, r0, part;
  float* t;      // RB: T_i of a flagged row
  int* last;     // RB: the list's last column
  int* slot;     // RB: -1 (no tie), its sums (0 .. G - 1), or G (direct)
  int* row_of;   // G: the block row of each slot
  int* nflag;    // the block's flagged rows
  float* acc;    // G x (3 c + 1): sum, sum of squares, max, count
  __device__ Rescan(const RescanParams& p, int b, int r0, int part)
      : p(p), b(b), r0(r0), part(part) {}
  __device__ bool init(unsigned char* smem, const Args& a) {
    t = (float*)smem;
    last = (int*)(t + RB);
    slot = last + RB;
    row_of = slot + RB;
    nflag = row_of + G;
    acc = (float*)(nflag + 4);
    for (int r = threadIdx.x; r < RB; r += 32 * W) {
      const size_t row = (size_t)b * a.m + r0 + r;
      const bool f = r0 + r < a.m && p.tie[row] != 0;
      slot[r] = f ? 0 : -1;
      t[r] = f ? p.kth[row] : 0.f;
      last[r] = f ? p.cols[row * a.k + a.k - 1] : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int nf = 0;
      for (int r = 0; r < RB; ++r)
        if (slot[r] >= 0) {
          if (nf < G) row_of[nf] = r;
          slot[r] = nf++;
        }
      if (nf > G)
        for (int r = 0; r < RB; ++r)
          if (slot[r] >= 0) slot[r] = G;
      *nflag = nf;
    }
    __syncthreads();
    const int nf = *nflag;
    if (nf == 0 || (nf > G && part != 0)) return false;
    const int stride = 3 * p.c + 1;
    for (int i = threadIdx.x; nf <= G && i < nf * stride; i += 32 * W) {
      const int e = i % stride;
      acc[i] = e >= 2 * p.c && e < 3 * p.c ? -CUDART_INF_F : 0.f;
    }
    return true;
  }
  __device__ __forceinline__ void columns(const Args& a, int prt, int& c_lo,
                                          int& c_hi) const {
    if (*nflag > G) {
      c_lo = 0;
      c_hi = a.n;
    } else {
      knn_walk::column_range(a.n, a.split, prt, c_lo, c_hi);
    }
  }
  __device__ __forceinline__ void tile(const Args& a, int rb, int rows,
                                       const float (&v)[RW], int c,
                                       bool valid) {
    const int lane = threadIdx.x & 31;
    const float* tab = p.feat + (size_t)b * a.n * p.c;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = rb + rr;
      const int sl = rr < rows ? slot[r] : -1;   // warp-uniform
      if (sl < 0) continue;
      const unsigned hit =
          __ballot_sync(FULL, valid && v[rr] == t[r] && c > last[r]);
      if (!hit) continue;
      if (sl == G) {
        const size_t row = (size_t)b * a.m + r0 + r;
        add_tied(tab, p.c, hit, c - lane, p.mx + row * p.c, p.sm + row * p.c,
                 p.sq + row * p.c, p.cnt + row);
      } else {
        float* s = acc + sl * (3 * p.c + 1);
        add_tied(tab, p.c, hit, c - lane, s + 2 * p.c, s, s + p.c,
                 s + 3 * p.c);
      }
    }
  }
  __device__ void end(const Args& a, int, int, int) {
    const int nf = *nflag;
    if (nf > G) return;   // added as found
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every block of the cluster has its sums
    const int stride = 3 * p.c + 1;
    for (int s = part; s < nf; s += a.split) {
      const size_t row = (size_t)b * a.m + r0 + row_of[s];
      for (int ch = threadIdx.x; ch <= p.c; ch += 32 * W) {
        if (ch == p.c) {   // the count
          float n = p.cnt[row];
          for (int src = 0; src < a.split; ++src)
            n += cluster.map_shared_rank(acc, src)[s * stride + 3 * p.c];
          p.cnt[row] = n;
          continue;
        }
        const size_t o = row * p.c + ch;
        float sm = p.sm[o], sq = p.sq[o], mx = p.mx[o];
        for (int src = 0; src < a.split; ++src) {
          const float* sums = cluster.map_shared_rank(acc, src) + s * stride;
          sm = sm + sums[ch];
          sq = sq + sums[p.c + ch];
          mx = fmaxf(mx, sums[2 * p.c + ch]);
        }
        p.sm[o] = sm;
        p.sq[o] = sq;
        p.mx[o] = mx;
      }
    }
    cluster.sync();   // no block leaves while another reads its sums
  }
};

template <int KPL>
int select_rows(const Args& g, const SelectOut& o, int batch, bool tensor,
                cudaStream_t st) {
  return launch<TieSelect, KPL, false>(g, o, batch, tensor, MAX_SPLIT, false,
                                       st);
}

}  // namespace

// geom: (B, N, D) float32, D <= 256 (>= 6 for points_normals); a: (B, N, C)
// float32 with C a multiple of 32 up to 256, N C < 2^32, 16-byte aligned;
// metric 0 = sqdist, 1 = points_normals; 1 <= k <= min(128, N); order:
// (B, N) int32, a permutation of each shape's rows that phase 2 walks, or
// null for the identity. Scratch: cols (B, N, k) int32, kth (B, N) float32, tie (B, N)
// int32. Outputs: mx, sm, sq (B, N, C) float32, cnt (B, N) float32. Three
// launches on `stream`, no synchronisation.
extern "C" int sednet_fused_edge_reductions(
    const void* geom, const void* a, const void* order, int batch, int n,
    int d, int c, int k, int metric, float w, void* cols, void* kth,
    void* tie, void* mx, void* sm, void* sq, void* cnt, void* stream) {
  if (batch < 1 || k < 1 || k > KMAX || k > n || c % 32 != 0 || c < 32 ||
      c > CMAX || d < 1 || d > 256 || (metric == 1 && d < 6))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool tensor = metric == 0 && d > SMALL_D;
  Args g;
  g.q = g.p = (const float*)geom;
  g.q_bstride = g.p_bstride = (long long)n * d;
  g.m = g.n = n;
  g.d = d;
  g.k = k;
  g.metric = metric;
  g.largest = 0;
  g.vec = (d & 3) == 0 && sim_tile::aligned16(geom);
  g.w = w;

  const SelectOut o = {nullptr, (int*)cols, (float*)kth, (int*)tie};
  int rc = k <= 32   ? select_rows<1>(g, o, batch, tensor, st)
           : k <= 64 ? select_rows<2>(g, o, batch, tensor, st)
                     : select_rows<4>(g, o, batch, tensor, st);
  if (rc) return rc;
  rc = gather_rows::launch<int>((const float*)a, (const int*)cols,
                                (const int*)order, batch, n, c, k, (float*)sm,
                                (float*)sq, (float*)mx, (float*)cnt, st);
  if (rc) return rc;
  const RescanParams rp = {(const int*)cols, (const float*)kth,
                           (const int*)tie, (const float*)a, c,
                           (float*)mx, (float*)sm, (float*)sq, (float*)cnt};
  return launch<Rescan, 1, false>(g, rp, batch, tensor, RSPLIT, true, st);
}
