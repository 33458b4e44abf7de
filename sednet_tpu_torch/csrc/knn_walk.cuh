// The column walk of the exact top-k: what a block of K1 (flash_topk.cu)
// does for its rows, shared with K4 (fused_edgeconv.cu), which walks the
// same columns with the same distance code and selection.
//
// A block of W warps (8, or 6 for one shape of few rows) owns RB = 8 W
// query rows of one shape, 8 a warp, and walks a range of columns 32 at a
// time. At every tile each lane holds, for each of its warp's 8 rows, the
// distance to its own column, and hands them to the walk's row action `Op`
// (the selection below, or K4's rescan of tied rows); after the walk, Op
// ends. Two walks form the distances:
//   * walk_small (D <= 8 and points_normals): each lane holds one column in
//     registers and computes its warp's 8 rows' distances on the CUDA cores
//     straight into the action; no tile, no barrier.
//   * walk_tensor (sqdist at D > 8): the block's 64 x 32 tile of q.p on the
//     tensor cores (mma.sync.m16n8k8, three-term TF32 split of sim_tile.cuh:
//     every product exact, short chains added in f32 on the CUDA cores), the
//     norms |q|^2 and |p|^2 summed in f32 from the staged rows (fmaf; four
//     partial sums over the channels c = 0, 1, 2, 3 mod 4, ascending, then
//     (s0 + s1) + (s2 + s3): the order in which the products' lanes read p);
//     rows zero-padded to a multiple of 16 in shared memory, q's split once
//     where there is room. Two warps share each 16-row m-tile, 16 columns
//     each, write it to their distance tile and act on 8 rows each from it.
//     p tiles land by cp.async in 2 to 4 stages (as many as keep the blocks
//     an SM) behind mbarriers, with no block-wide barrier in the walk: a
//     warp that merges a queue holds back its m-tile partner, and the others
//     only once it falls as many tiles behind as the ring runs ahead.
// Either way a distance's bits depend only on its row, its column and the
// width, never on the block, the variant or the row action, so every walk
// of the same rows sees the same values.
//
// The selection (SelectOp, with knn_select.cuh): each row's best KP >= k
// pairs sit in shared memory, ascending by (value, column), beside a queue
// of QP candidates (64; 32 where that fits more blocks on an SM, or k <=
// 32) and the value of the row's k-th pair, the threshold. A warp takes a
// tile's 32 candidates of each of its 8 rows at once (8 ballots, no branch
// between the rows) and appends those not above the threshold to the row's
// queue (each lane writes its own, at its rank among the row's hits). When
// a queue would overflow, or at the end, the warp sorts it (bitonic, over
// shuffles), merges it into the list in registers and takes the new
// threshold. So a candidate costs a compare and a ballot, a hit a store, and
// the list's work is paid QP hits at a time: random order gives some
// k (1 + ln(n/k)) hits a row (about 390 for a 10000-point graph at k = 64).
// With TIES (K4), the selection also keeps, beside the threshold, the least
// value it ever pushed out of a row's list: a column rejected at a ballot or
// at a flush lies strictly above the final threshold, so only a pushed-out
// pair, or an entry of the list past k, can tie the k-th value; the row's
// tie flag is that minimum against the k-th value at the end.
//
// Launch: of the compiled variants (queue length; q split once or at every
// k-step) the one with the most blocks an SM, since the kernel waits on
// latency; the choice is made once a device, list length, path and width.
// Where blocks of 64 rows run one an SM and leave SMs idle (one shape of
// 5000 rows at k = 128: 79 blocks for 132 SMs), blocks of 48 rows (6 warps,
// 105 blocks) spread the rows over more SMs. Where the row blocks leave room
// on the card (157 for one 10000-point shape), a cluster of 2 or 4 blocks
// splits each row block's columns, as far as they still fit at once, and
// the partial lists of a row merge by the (value, column) key through
// distributed shared memory, in rank order, with no atomics and no scratch.
// Each part refills its own list, so a split that adds a wave costs more
// than it gains. Batched inputs are one launch with the batch on the grid's
// y axis.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "knn_select.cuh"
#include "sim_tile.cuh"

namespace knn_walk {
namespace {   // each source that includes this gets its own kernels

namespace cg = cooperative_groups;
using knn_select::NO_COL;

constexpr int RW = 8;         // rows a warp acts on (a block: 8 W rows)
constexpr int WARPS = 8;      // warps of a block (6 where `launch` says)
constexpr int CB = 32;        // columns per tile
constexpr int WPM = 2;        // warps an m-tile of 16 rows (tensor path)
constexpr int CW = CB / WPM;  // columns a warp computes of a tile
constexpr int NT = CW / 8;    // its 8-column n-tiles
constexpr int KC = 2;         // k-steps summed in one fresh fragment
constexpr int WS = CB + 1;    // row stride of a distance tile
constexpr int SMALL_D = 8;    // widest sqdist row of the CUDA-core path
constexpr int QS = 12;        // row stride of q there: 8 channels, |q|^2, pad
constexpr int MAX_SPLIT = 4;  // blocks of a cluster
constexpr int MAX_STAGES = 4; // p-tile stages of the tensor path
constexpr unsigned FULL = 0xffffffffu;

// The walk's inputs: rows q (B, M, D) against columns p (B, N, D).
struct Args {
  const float* q;
  const float* p;
  long long q_bstride, p_bstride;
  int m, n, d, k, metric, largest, split;
  int stages;           // p-tile stages of the tensor path
  int vec;              // 16-byte copies: D % 4 == 0 and q, p aligned
  float w;
  // K1's column ids: the id a column is listed and ordered by, (B, N)
  // int32 with batch stride col_bstride (0 shares one table); null lists
  // the column's own index
  const int* col_ids = nullptr;
  long long col_bstride = 0;
};

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// The columns [c_lo, c_hi) that block `part` of `split` walks.
__device__ __forceinline__ void column_range(int n, int split, int part,
                                             int& c_lo, int& c_hi) {
  const int per = ((n + split - 1) / split + CB - 1) / CB * CB;
  c_lo = min(n, part * per);
  c_hi = min(n, c_lo + per);
}

// ---------------------------------------------------------------------------
// The selection.

// The selection state of a block's rows, in shared memory: lists (KP =
// 32 KPL pairs a row), queues (QP = 32 QPL pairs a row, QPL <= KPL),
// thresholds, queue lengths and, with TIES, the least value pushed out.
struct Select {
  float* lv;
  int* li;
  float* qv;
  int* qi;
  float* thr;
  int* qlen;
  float* low;
};

__host__ __device__ constexpr int select_bytes(int rb, int kpl, int qpl,
                                               bool ties) {
  return round16(rb * 32 * (kpl + qpl) * 8 + rb * 8 + (ties ? rb * 4 : 0));
}

// Empty lists of a block of W warps (the caller syncs before use).
template <int W, int KPL, int QPL, bool TIES>
__device__ __forceinline__ Select init_select(unsigned char* smem) {
  constexpr int KP = 32 * KPL, QP = 32 * QPL, RB = RW * W;
  Select s;
  s.lv = (float*)smem;
  s.li = (int*)(s.lv + RB * KP);
  s.qv = (float*)(s.li + RB * KP);
  s.qi = (int*)(s.qv + RB * QP);
  s.thr = (float*)(s.qi + RB * QP);
  s.qlen = (int*)(s.thr + RB);
  s.low = TIES ? (float*)(s.qlen + RB) : nullptr;
  for (int i = threadIdx.x; i < RB * KP; i += 32 * W) {
    s.lv[i] = CUDART_INF_F;
    s.li[i] = NO_COL;
  }
  for (int i = threadIdx.x; i < RB; i += 32 * W) {
    s.thr[i] = CUDART_INF_F;
    s.qlen[i] = 0;
    if (TIES) s.low[i] = CUDART_INF_F;
  }
  return s;
}

// Merge row r's queue of qn <= QP candidates into its list; returns the
// value of the new k-th pair. With TIES, lowers the row's pushed-out
// minimum by what the merge dropped (one warp min).
template <int KPL, int QPL, bool TIES>
__device__ __forceinline__ float flush(const Select& s, int r, int qn,
                                       int k) {
  constexpr int KP = 32 * KPL, QP = 32 * QPL;
  const int lane = threadIdx.x & 31;
  __syncwarp();   // the queue's entries were written by other lanes
  float cv[QPL];
  int ci[QPL];
#pragma unroll
  for (int j = 0; j < QPL; ++j) {
    const int e = 32 * j + lane;
    cv[j] = e < qn ? s.qv[r * QP + e] : CUDART_INF_F;
    ci[j] = e < qn ? s.qi[r * QP + e] : NO_COL;
  }
  __syncwarp();   // read before the next hits overwrite it
  float v[KPL];
  int ix[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    v[j] = s.lv[r * KP + 32 * j + lane];
    ix[j] = s.li[r * KP + 32 * j + lane];
  }
  const float dropped = knn_select::add_sorted(v, ix, cv, ci);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    s.lv[r * KP + 32 * j + lane] = v[j];
    s.li[r * KP + 32 * j + lane] = ix[j];
  }
  if (TIES) s.low[r] = fminf(s.low[r], knn_select::warp_min(dropped));
  return knn_select::value_at(v, k - 1);
}

// flush, out of line: the tile step without a merge stays small.
template <int KPL, int QPL, bool TIES>
__device__ __noinline__ float flush_row(Select s, int r, int qn, int k) {
  return flush<KPL, QPL, TIES>(s, r, qn, k);
}

// One tile's candidates of the warp's RW rows (from block row rb, `rows`
// of them real): v[rr] is row rr's candidate in column c, one a lane. The
// rows are independent, so each step runs for all of them at once: test
// against the thresholds, flush the queues that would overflow, append.
// Every lane writes the same threshold and queue length, so each reads
// back what it wrote.
template <int KPL, int QPL, bool TIES>
__device__ __forceinline__ void select_tile(const Select& s, int rb,
                                            int rows, const float (&v)[RW],
                                            int c, bool valid, int k) {
  constexpr int QP = 32 * QPL;
  const int lane = threadIdx.x & 31;
  bool pass[RW];
  unsigned hit[RW], any = 0;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    pass[rr] = valid && rr < rows && v[rr] <= s.thr[rb + rr];
    hit[rr] = __ballot_sync(FULL, pass[rr]);
    any |= hit[rr];
  }
  if (!any) return;
  int qn[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    qn[rr] = s.qlen[rb + rr];
    if (qn[rr] + __popc(hit[rr]) > QP) {
      const float tv = flush_row<KPL, QPL, TIES>(s, rb + rr, qn[rr], k);
      s.thr[rb + rr] = tv;
      qn[rr] = 0;
      pass[rr] = pass[rr] && v[rr] <= tv;
      hit[rr] = __ballot_sync(FULL, pass[rr]);
    }
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = rb + rr;
    if (pass[rr]) {
      const int pos = qn[rr] + __popc(hit[rr] & below);
      s.qv[r * QP + pos] = v[rr];
      s.qi[r * QP + pos] = c;
    }
    s.qlen[r] = qn[rr] + __popc(hit[rr]);   // 0 after a flush and no hit
  }
}

// After the column walk: merge what is left in the queues of the warp's
// rows, from block row rb on.
template <int KPL, int QPL, bool TIES>
__device__ __forceinline__ void flush_all(const Select& s, int rb, int rows,
                                          int k) {
  for (int rr = 0; rr < rows; ++rr) {
    const int qn = s.qlen[rb + rr];
    if (qn) flush<KPL, QPL, TIES>(s, rb + rr, qn, k);
  }
}

// Where the selection writes: `cols` (B, M, k) int32 always; K1 the k
// values (`dist`, negated back where `largest`); K4 (TIES) each row's k-th
// value (`kth`, (B, M)) and whether a column outside the k ties it (`tie`).
struct SelectOut {
  float* dist;
  int* cols;
  float* kth;
  int* tie;
};

// Merge the cluster's partial lists of each row and write the first k.
// Block `part` finishes rows [part, part + 1) * RB / split.
template <int W, int KPL, bool TIES>
__device__ void finish(const Args& a, const SelectOut& o, const Select& s,
                       int b, int r0, int part) {
  constexpr int KP = 32 * KPL, RB = RW * W;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block of the cluster has its lists
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = RB / a.split;
  for (int rr = warp; rr < per; rr += W) {
    const int r = part * per + rr;
    if (r0 + r >= a.m) break;
    float v[KPL];
    int ix[KPL];
    const float* v0 = cluster.map_shared_rank(s.lv, 0) + r * KP;
    const int* i0 = cluster.map_shared_rank(s.li, 0) + r * KP;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      v[j] = v0[32 * j + lane];
      ix[j] = i0[32 * j + lane];
    }
    float low = TIES ? cluster.map_shared_rank(s.low, 0)[r] : CUDART_INF_F;
    for (int src = 1; src < a.split; ++src) {
      const float* vs = cluster.map_shared_rank(s.lv, src) + r * KP;
      const int* is = cluster.map_shared_rank(s.li, src) + r * KP;
      float rv[KPL];
      int ri[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        rv[j] = vs[KP - 1 - 32 * j - lane];
        ri[j] = is[KP - 1 - 32 * j - lane];
      }
      const float dropped = knn_select::merge_reversed(v, ix, rv, ri);
      if (TIES)
        low = fminf(low, fminf(dropped,
                               cluster.map_shared_rank(s.low, src)[r]));
    }
    const size_t row = (size_t)b * a.m + r0 + r;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int e = 32 * j + lane;
      if (e < a.k) {
        if (!TIES) o.dist[row * a.k + e] = a.largest ? -v[j] : v[j];
        o.cols[row * a.k + e] = ix[j];
      } else if (TIES) {
        low = fminf(low, v[j]);   // entries past k are outside the set too
      }
    }
    if (TIES) {
      const float kth = knn_select::value_at(v, a.k - 1);
      low = knn_select::warp_min(low);
      if (lane == 0) {
        o.kth[row] = kth;
        o.tie[row] = low == kth;
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its lists
}

// The selection as a walk's row action: K1's top-k (TIES false) or K4's
// phase 1 (TIES true).
template <int W, int KPL, int QPL, bool TIES>
struct SelectOp {
  using Params = SelectOut;
  __host__ __device__ static constexpr int bytes() {
    return select_bytes(RW * W, KPL, QPL, TIES);
  }
  SelectOut out;
  int b, r0;
  Select s;
  const int* ids;   // this shape's column ids, or null
  __device__ SelectOp(const SelectOut& out, int b, int r0, int)
      : out(out), b(b), r0(r0) {}
  __device__ bool init(unsigned char* smem, const Args& a) {
    s = init_select<W, KPL, QPL, TIES>(smem);
    ids = a.col_ids != nullptr ? a.col_ids + b * a.col_bstride : nullptr;
    return true;
  }
  __device__ __forceinline__ void columns(const Args& a, int part,
                                          int& c_lo, int& c_hi) const {
    column_range(a.n, a.split, part, c_lo, c_hi);
  }
  __device__ __forceinline__ void tile(const Args& a, int rb, int rows,
                                       const float (&v)[RW], int c,
                                       bool valid) {
    // a column enters the lists under its id, so that ties go to the
    // lower id whatever order the columns are walked in
    const int id = (ids != nullptr && valid) ? __ldg(ids + c) : c;
    select_tile<KPL, QPL, TIES>(s, rb, rows, v, id, valid, a.k);
  }
  __device__ __forceinline__ void end(const Args& a, int rb, int rows,
                                      int part) {
    flush_all<KPL, QPL, TIES>(s, rb, rows, a.k);
    finish<W, KPL, TIES>(a, out, s, b, r0, part);
  }
};

template <int W, int KPL, int QPL>
struct TopkSelect : SelectOp<W, KPL, QPL, false> {
  using SelectOp<W, KPL, QPL, false>::SelectOp;
};
template <int W, int KPL, int QPL>
struct TieSelect : SelectOp<W, KPL, QPL, true> {
  using SelectOp<W, KPL, QPL, true>::SelectOp;
};

template <template <int, int, int> class Op>
using ParamsOf = typename Op<WARPS, 1, 1>::Params;

// ---------------------------------------------------------------------------
// The walks. Op<W, KPL, QPL> is the row action: its shared state (bytes()
// of it, at the start of shared memory), init (by every thread; true where
// the thread found work, and a block where none did returns at once), the
// columns a block of the cluster walks, tile (the warp's RW rows'
// candidates of a tile) and end.

// D <= 8 and points_normals: distances on the CUDA cores, lane by column.
// DC: the channels read, 3 (sqdist on xyz), 6 (points_normals) or 8 (any
// other sqdist width up to 8, zero-padded).
template <int KPL, int QPL, int DC, template <int, int, int> class OpT>
__global__ void __launch_bounds__(32 * WARPS)
walk_small(Args a, ParamsOf<OpT> prm) {
  using Op = OpT<WARPS, KPL, QPL>;
  constexpr int DN = DC == 6 ? 3 : DC;   // channels of the squared norms
  constexpr int RB = RW * WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = (float*)(smem + Op::bytes());   // RB x QS
  const int b = blockIdx.y;
  const int part = (int)(blockIdx.x % a.split);
  const int r0 = (int)(blockIdx.x / a.split) * RB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Op op(prm, b, r0, part);
  if (!__syncthreads_or(op.init(smem, a))) return;
  const float* qb = a.q + b * a.q_bstride;
  const float* pb = a.p + b * a.p_bstride;
  const int dc = min(DC, a.d);

  for (int r = threadIdx.x; r < RB; r += 32 * WARPS) {
    float qq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = (r0 + r < a.m && e < dc)
                          ? qb[(size_t)(r0 + r) * a.d + e] : 0.f;
      qs[r * QS + e] = x;
      if (e < DN) qq = fmaf(x, x, qq);
    }
    qs[r * QS + 8] = qq;
  }
  __syncthreads();

  const int rb = warp * RW;
  int c_lo, c_hi;
  op.columns(a, part, c_lo, c_hi);
  const int rows = min(RW, max(0, a.m - r0 - rb));
  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    const int c = c0 + lane;
    const bool valid = c < c_hi;
    float pv[DC];
#pragma unroll
    for (int e = 0; e < DC; ++e)
      pv[e] = (valid && e < dc) ? pb[(size_t)c * a.d + e] : 0.f;
    float pp = 0.f;
#pragma unroll
    for (int e = 0; e < DN; ++e) pp = fmaf(pv[e], pv[e], pp);
    float v[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const float* qr = qs + (rb + rr) * QS;
      const float4 q0 = *(const float4*)qr;
      float sd = fmaf(q0.x, pv[0], 0.f);
      sd = fmaf(q0.y, pv[1], sd);
      sd = fmaf(q0.z, pv[2], sd);
      float dv;
      if (DC == 6) {
        const float2 q1 = *(const float2*)(qr + 4);
        float sn = fmaf(q0.w, pv[3 % DC], 0.f);
        sn = fmaf(q1.x, pv[4 % DC], sn);
        sn = fmaf(q1.y, pv[5 % DC], sn);
        dv = (qr[8] + pp - 2.f * sd) * (1.f + a.w * (2.f - 2.f * sn));
      } else {
        if (DC == 8) {
          const float4 q1 = *(const float4*)(qr + 4);
          sd = fmaf(q0.w, pv[3 % DC], sd);
          sd = fmaf(q1.x, pv[4 % DC], sd);
          sd = fmaf(q1.y, pv[5 % DC], sd);
          sd = fmaf(q1.z, pv[6 % DC], sd);
          sd = fmaf(q1.w, pv[7 % DC], sd);
        }
        dv = qr[8] + pp - 2.f * sd;
      }
      v[rr] = a.largest ? -dv : dv;
    }
    op.tile(a, rb, rows, v, c, valid);
  }
  op.end(a, rb, rows, part);
}

// Rows [r0, r0 + rows) of a (n, d) array into shared memory at stride st,
// zero past d (up to the padded width E) and past n; 16-byte copies when
// d is a multiple of 4 and the array is aligned, else 4-byte ones; by a
// block of T threads.
template <int T>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows, int n, int d,
                                          int E, int st, bool vec) {
  if (vec) {
    const int chunks = E / 4;
    for (int i = threadIdx.x; i < rows * chunks; i += T) {
      const int r = i / chunks, ch = i % chunks;
      const bool ok = r0 + r < n && 4 * ch < d;
      sim_tile::cp_async16(dst + r * st + 4 * ch,
                           src + (ok ? (size_t)(r0 + r) * d + 4 * ch : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * E; i += T) {
      const int r = i / E, e = i % E;
      const bool ok = r0 + r < n && e < d;
      const uint32_t sa = (uint32_t)__cvta_generic_to_shared(dst + r * st + e);
      const float* g = src + (ok ? (size_t)(r0 + r) * d + e : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                   :: "r"(sa), "l"(g), "r"(ok ? 4 : 0) : "memory");
    }
  }
}

__host__ __device__ inline int padded_width(int d) {
  return (d + 15) / 16 * 16;
}

// mbarriers of the tensor path's p-tile stages: "full" completes when every
// thread's copies of a tile have landed (cp.async.mbarrier.arrive.noinc,
// one arrival a thread), "empty" when every warp has read it (one a warp).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.shared.b64 st, [%0]; }"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete. A pipeline that never
// completes (a fault in this file) ends the launch with an error rather
// than spinning for good.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1 << 22)) __trap();
  }
}

// Shared memory of a block of rb rows: the row action's state (op_bytes),
// then the path's tiles (with `pre`, q's rows twice: their TF32 hi and lo
// parts; ns stages of p tiles).
__host__ inline int smem_bytes(int op_bytes, int rb, int d, bool tensor,
                               bool pre, int ns) {
  if (!tensor) return op_bytes + rb * QS * 4;
  const int st = padded_width(d) + 4;
  return op_bytes + 2 * MAX_STAGES * 8 +
         ((pre ? 2 : 1) * rb * st + ns * CB * st + rb + rb * WS) * 4;
}

// sqdist at D > 8: q.p on the tensor cores by the three-term TF32 split.
// W warps, RB = 8 W rows in W / 2 m-tiles of 16. PRE: q's rows are split
// once, into hi and lo parts side by side in shared memory (where it has
// room), not at every k-step.
template <int W, int KPL, int QPL, bool PRE,
          template <int, int, int> class OpT>
__global__ void __launch_bounds__(32 * W, 2)
walk_tensor(Args a, ParamsOf<OpT> prm) {
  using Op = OpT<W, KPL, QPL>;
  constexpr int RB = RW * W, T = 32 * W, MT = W / WPM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = padded_width(a.d);
  const int S = E + 4;
  const int ns = a.stages;
  uint64_t* full = (uint64_t*)(smem + Op::bytes());   // ns stages
  uint64_t* empty = full + MAX_STAGES;
  float* qs = (float*)(empty + MAX_STAGES);  // RB x S
  float* qlo = qs + RB * S;             // RB x S with PRE
  float* ps = qlo + (PRE ? RB * S : 0);  // ns stages of CB x S
  float* qq = ps + ns * CB * S;         // RB
  float* dt = qq + RB;                  // RB x WS
  const int b = blockIdx.y;
  const int part = (int)(blockIdx.x % a.split);
  const int r0 = (int)(blockIdx.x / a.split) * RB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  Op op(prm, b, r0, part);
  if (!__syncthreads_or(op.init(smem, a))) return;
  const float* qb = a.q + b * a.q_bstride;
  const float* pb = a.p + b * a.p_bstride;

  int c_lo, c_hi;
  op.columns(a, part, c_lo, c_hi);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(full + i, T);
      mbar_init(empty + i, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  load_rows<T>(qs, qb, r0, RB, a.m, a.d, E, S, a.vec);
  sim_tile::cp_async_commit();
  sim_tile::cp_async_wait<0>();
  __syncthreads();   // q's rows, the row action's state and the mbarriers
  for (int i = 0; i < ns - 1 && c_lo + i * CB < c_hi; ++i) {
    load_rows<T>(ps + i * CB * S, pb, c_lo + i * CB, CB, c_hi, a.d, E, S,
                 a.vec);
    mbar_arrive_copies(full + i);
  }
  // |q|^2 in the order in which the tile's lanes sum |p|^2 below
  for (int r = threadIdx.x; r < RB; r += T) {
    float part4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e = 0; e < E; e += 4)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part4[c] = fmaf(qs[r * S + e + c], qs[r * S + e + c], part4[c]);
    qq[r] = (part4[0] + part4[1]) + (part4[2] + part4[3]);
  }
  __syncthreads();
  if (PRE) {
    for (int i = threadIdx.x; i < RB * S; i += T) {
      uint32_t hi, lo;
      sim_tile::split(qs[i], hi, lo);
      qs[i] = __uint_as_float(hi);
      qlo[i] = __uint_as_float(lo);
    }
    __syncthreads();
  }

  // warps mt, mt + MT share m-tile mt (rows 16 mt ..): columns CW h .. of
  // each tile for the products, rows 16 mt + RW h .. for the row action
  const int mt = warp % MT, h = warp / MT;
  const float* arow = qs + 16 * mt * S;
  const float* arow_lo = qlo + 16 * mt * S;
  float* mtile = dt + 16 * mt * WS;
  const int rb = 16 * mt + RW * h;
  const int rows = min(RW, max(0, a.m - r0 - rb));
  // No block-wide barrier in the walk: a warp waits for a tile to land
  // (full) and, before it refills a stage with the tile ns - 1 ahead, for
  // every warp to have read the tile there (empty), which each does before
  // its row action; so a warp merging a queue delays the others only once
  // it falls ns - 1 tiles behind.
  for (int c0 = c_lo, it = 0, stage = 0, phase = 0; c0 < c_hi;
       c0 += CB, ++it) {
    mbar_wait(full + stage, phase);
    const float* cols = ps + stage * CB * S + CW * h * S;

    // sim: q.p; pn[j]: this lane's part of |p|^2 of column 8 j + g, over
    // the channels t, t + 4, t + 8, .. (the ones its B fragments hold)
    float sim[NT][4], pn[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pn[j] = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) sim[j][v] = 0.f;
    }
#pragma unroll 4
    for (int k0 = 0; k0 < E / 8; k0 += KC) {
      float lohi[NT][4], hilo[NT][4], hihi[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) lohi[j][v] = hilo[j][v] = hihi[j][v] = 0.f;
#pragma unroll
      for (int kk = k0; kk < k0 + KC; ++kk) {
        const int ao = g * S + 8 * kk + t;
        uint32_t ahi[4], alo[4];
        if (PRE) {
          const int off[4] = {ao, ao + 8 * S, ao + 4, ao + 8 * S + 4};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ahi[i] = __float_as_uint(arow[off[i]]);
            alo[i] = __float_as_uint(arow_lo[off[i]]);
          }
        } else {
          sim_tile::split(arow[ao], ahi[0], alo[0]);
          sim_tile::split(arow[ao + 8 * S], ahi[1], alo[1]);
          sim_tile::split(arow[ao + 4], ahi[2], alo[2]);
          sim_tile::split(arow[ao + 8 * S + 4], ahi[3], alo[3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* bp = cols + (8 * j + g) * S + 8 * kk + t;
          const float b0 = bp[0], b1 = bp[4];
          pn[j] = fmaf(b1, b1, fmaf(b0, b0, pn[j]));
          uint32_t bhi[2], blo[2];
          sim_tile::split(b0, bhi[0], blo[0]);
          sim_tile::split(b1, bhi[1], blo[1]);
          sim_tile::mma(lohi[j], alo, bhi);
          sim_tile::mma(hilo[j], ahi, blo);
          sim_tile::mma(hihi[j], ahi, bhi);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          sim[j][v] += (lohi[j][v] + hilo[j][v]) + hihi[j][v];
    }
    // (s0 + s1) + (s2 + s3) in each lane of group g, as for |q|^2
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pn[j] += __shfl_xor_sync(FULL, pn[j], 1);
      pn[j] += __shfl_xor_sync(FULL, pn[j], 2);
    }
    // the m-tile's warps are done with the last tile's distances
    asm volatile("bar.sync %0, %1;" :: "r"(1 + mt), "r"(32 * WPM) : "memory");
    // C fragment v of n-tile j: row g + 8 (v / 2), column 8 j + 2 t + v % 2,
    // whose |p|^2 lane 4 (2 t + v % 2) holds
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float pc[2] = {__shfl_sync(FULL, pn[j], 8 * t),
                           __shfl_sync(FULL, pn[j], 8 * t + 4)};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = g + 8 * (v >> 1), c = 8 * j + 2 * t + (v & 1);
        const float dv = qq[16 * mt + r] + pc[v & 1] - 2.f * sim[j][v];
        mtile[r * WS + CW * h + c] = a.largest ? -dv : dv;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);   // this warp read the stage
    // refill the stage of tile it - 1 with tile it + ns - 1, once every
    // warp has read it
    const int rs = stage ? stage - 1 : ns - 1;
    if (c0 + (ns - 1) * CB < c_hi) {
      if (it > 0) mbar_wait(empty + rs, stage ? phase : phase ^ 1);
      load_rows<T>(ps + rs * CB * S, pb, c0 + (ns - 1) * CB, CB, c_hi, a.d,
                   E, S, a.vec);
      mbar_arrive_copies(full + rs);
    }
    if (++stage == ns) {
      stage = 0;
      phase ^= 1;
    }
    // the m-tile's warps have all written it (named barrier 1 + mt)
    asm volatile("bar.sync %0, %1;" :: "r"(1 + mt), "r"(32 * WPM) : "memory");
    const int c = c0 + lane;
    const bool valid = c < c_hi;
    float v[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) v[rr] = mtile[(RW * h + rr) * WS + lane];
    op.tile(a, rb, rows, v, c, valid);
  }
  op.end(a, rb, rows, part);
}

// ---------------------------------------------------------------------------
// Launch.

constexpr int SMEM_MAX = 232448;   // a block's shared memory on sm_90

// A compiled kernel of a path: its warps, queue length (32 qpl), whether it
// splits q once, and its row action's shared bytes.
template <class P>
struct Variant {
  void (*kernel)(Args, P);
  int warps, qpl;
  bool pre;
  int op_bytes;
};

// The variants of a path for lists of 32 KPL, in the order tried: queue
// length 64 before 32 and, on the tensor path, q split once before at
// every k-step. kind: 0 tensor path (W warps, padded width E), 1
// points_normals, 2 sqdist at D = 3, 3 other sqdist at D <= 8 (these three
// with WARPS warps).
template <template <int, int, int> class Op, int KPL, int W>
int variants(int kind, Variant<ParamsOf<Op>>* c) {
  constexpr int Q2 = KPL < 2 ? KPL : 2;   // 64-entry queues where k > 32
  constexpr int B2 = Op<W, KPL, Q2>::bytes(), B1 = Op<W, KPL, 1>::bytes();
  constexpr int S2 = Op<WARPS, KPL, Q2>::bytes();
  constexpr int S1 = Op<WARPS, KPL, 1>::bytes();
  if (kind == 0) {
    c[0] = {walk_tensor<W, KPL, Q2, true, Op>, W, Q2, true, B2};
    c[1] = {walk_tensor<W, KPL, 1, true, Op>, W, 1, true, B1};
    c[2] = {walk_tensor<W, KPL, Q2, false, Op>, W, Q2, false, B2};
    c[3] = {walk_tensor<W, KPL, 1, false, Op>, W, 1, false, B1};
    return 4;
  }
  if (kind == 1) {
    c[0] = {walk_small<KPL, Q2, 6, Op>, WARPS, Q2, false, S2};
    c[1] = {walk_small<KPL, 1, 6, Op>, WARPS, 1, false, S1};
  } else if (kind == 2) {
    c[0] = {walk_small<KPL, Q2, 3, Op>, WARPS, Q2, false, S2};
    c[1] = {walk_small<KPL, 1, 3, Op>, WARPS, 1, false, S1};
  } else {
    c[0] = {walk_small<KPL, Q2, 8, Op>, WARPS, Q2, false, S2};
    c[1] = {walk_small<KPL, 1, 8, Op>, WARPS, 1, false, S1};
  }
  return 2;
}

// The variant with the most blocks an SM (the kernel waits on latency, so
// occupancy comes first; the first of equals), with as many p-tile stages
// (tensor path, 2 to MAX_STAGES) as keep its blocks an SM: its shared
// memory, stages, blocks and the SMs.
template <class P>
struct Choice {
  Variant<P> v;
  int bytes, stages, blocks, sms;
};

// The choice of a device, list length, path, width and block size, made at
// its first call (which also sets the kernels' shared-memory limit there)
// and kept.
template <template <int, int, int> class Op, int KPL, int W>
int choose(int dev, int kind, int E, Choice<ParamsOf<Op>>& out) {
  using P = ParamsOf<Op>;
  static std::mutex mu;
  static std::map<std::array<int, 3>, Choice<P>> made;
  const std::array<int, 3> key = {dev, kind, E};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = made.find(key);
  if (it != made.end()) {
    out = it->second;
    return 0;
  }
  Choice<P> ch = {{nullptr, 0, 0, false, 0}, 0, 0, 0, 0};
  cudaError_t err =
      cudaDeviceGetAttribute(&ch.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Variant<P> c[4];
  const int nc = variants<Op, KPL, W>(kind, c);
  for (int i = 0; i < nc; ++i) {
    // the limit of the function, whatever width it is launched at
    err = cudaFuncSetAttribute(
        c[i].kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0, stages = 0;
    for (int ns = 2; ns <= (kind == 0 ? MAX_STAGES : 2); ++ns) {
      const int bytes = smem_bytes(c[i].op_bytes, RW * W, E, kind == 0,
                                   c[i].pre, ns);
      int b = 0;
      if (bytes > SMEM_MAX) break;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, c[i].kernel, 32 * c[i].warps, bytes);
      if (err != cudaSuccess) return (int)err;
      if (ns > 2 && b < blocks) break;
      blocks = b;
      stages = ns;
    }
    if (blocks > ch.blocks) {
      ch.v = c[i];
      ch.bytes = smem_bytes(c[i].op_bytes, RW * W, E, kind == 0, c[i].pre,
                            stages);
      ch.stages = stages;
      ch.blocks = blocks;
    }
  }
  if (!ch.v.kernel) return (int)cudaErrorInvalidConfiguration;
  made[key] = ch;
  out = ch;
  return 0;
}

// One walk of a.q's rows with row action Op (lists of 32 KPL), batched on
// the grid's y axis. SIX: blocks of 6 warps may replace those of 8 (see the
// head of this file); max_split: the most blocks of a cluster that may
// split a row block's columns, as far as they fit the card at once, or,
// with `always`, regardless (an Op whose blocks mostly return at once).
template <template <int, int, int> class Op, int KPL, bool SIX>
int launch(Args a, const ParamsOf<Op>& prm, int batch, bool tensor,
           int max_split, bool always, cudaStream_t stream) {
  using P = ParamsOf<Op>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int kind = tensor ? 0 : a.metric == 1 ? 1 : a.d == 3 ? 2 : 3;
  const int E = tensor ? padded_width(a.d) : 0;
  Choice<P> ch;
  int rc = choose<Op, KPL, WARPS>(dev, kind, E, ch);
  if (rc) return rc;
  // blocks of 48 rows where those of 64 run one an SM and leave SMs idle,
  // if they still fit the card at once
  if (SIX && tensor && ch.blocks == 1 &&
      batch * ((a.m + RW * WARPS - 1) / (RW * WARPS)) < ch.sms) {
    Choice<P> c6;
    if ((rc = choose<Op, KPL, SIX ? 6 : WARPS>(dev, kind, E, c6))) return rc;
    if (batch * ((a.m + RW * 6 - 1) / (RW * 6)) <= c6.sms * c6.blocks)
      ch = c6;
  }
  const int rb = RW * ch.v.warps;
  a.stages = ch.stages;
  // a cluster splits the columns, 2 or 4 ways, while the blocks still fit
  // the card at once (157 row blocks of one 10000-row shape split in 2 at
  // four blocks an SM)
  const int row_blocks = batch * ((a.m + rb - 1) / rb);
  a.split = 1;
  while (2 * a.split <= max_split &&
         (always || row_blocks * a.split * 2 <= ch.sms * ch.blocks))
    a.split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks / batch * a.split, batch);
  cfg.blockDim = dim3(32 * ch.v.warps);
  cfg.dynamicSmemBytes = ch.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ch.v.kernel, a, prm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace knn_walk
