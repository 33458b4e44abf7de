// Backward of the neighbour gather-reduce (K6b).
//
// K6 (gather_reduce.cu) computes, for every shape b, row i and channel c,
// with j_k = clamp(idx[b, i, k], 0, N - 1), the sum s, the sum of squares
// sq and the max mx of a[b, j_k, c] over k. Given their cotangents gs, gsq
// and gmx (each B x N x C), this kernel computes the table's gradient
//
//   da[j, c] = sum over (i, k) with j_k = j of
//              gs[i, c] + 2 a[j, c] gsq[i, c]
//              + [a[j, c] == mx[i, c]] gmx[i, c] / cnt[i, c],
//   cnt[i, c] = #{k : a[j_k, c] == mx[i, c]},
//
// the max's cotangent split evenly over its ties, as JAX's reduce_max VJP
// and torch's amax backward split it. A neighbour listed twice in a row
// counts twice. mx is the forward's output, a copy of one of the gathered
// values, so the comparison is exact.
//
// It replaces no Pallas kernel: the JAX package differentiates XLA's flat
// gather (sednet_tpu/ops/graph.py:118-121) under jax.value_and_grad
// (sednet_tpu/train.py:128). Its plain PyTorch version is
// ops/graph.py gather_reduce_backward_plain.
//
// What bounds it on the H100. The unique traffic is a, mx, gs, gsq and gmx
// read once (B N C floats each), the int64 indices (B N K) and da written:
// 81.9 MB at B = 4, N = 10000, K = 64, C = 64, 0.0245 ms at 3.35 TB/s. The
// design below moves more: the transpose (the int64 graph read, 2.56 M
// int32 keys and edge ids sorted in two radix passes), the mask (B N K C / 8
// bytes, 20.5 MB there) and w (B N C floats) written and read once, and,
// mostly from L1 and L2, one row of a per edge in pass 1 and two rows (gs,
// gsq) and the tied channels of w per edge in pass 2 (0.66 and about 1.4
// GB at that shape; at C = 128, w's whole row too).
//
// Design: the gradient is summed per destination, over the graph's
// transpose, with no float atomics. Every element of da is written once, by
// the lane that owns it, from a sum whose order the graph alone fixes, so
// the result is the same bits on every launch and under every row order.
//
//  * The transpose (sednet_graph_transpose; ops/graph.py graph_transpose):
//    each edge e = (b N + i) K + k keyed by its destination b N + j_k, CUB's
//    stable radix sort of (key, e) on the bits of B N - 1 alone (16 at
//    B N = 40000: two passes), and each destination's end from the sorted
//    keys. CUB's sort is index bookkeeping: the gradient's arithmetic is
//    the two passes that follow.
//  * Pass 1, source side (k6b_sources): a warp a row along `order`, K6's
//    walk over the row's K neighbours (16 rows loaded ahead at C <= 64),
//    lane l owning the CJ = C / 32 channels l CJ .. l CJ + CJ - 1. It reads
//    each neighbour's row once and writes the ties of the max as a mask of
//    C bits an edge (word u of edge e holds, at bit l, the tie of channel
//    l CJ + u: one ballot a word, stored 32 words at a time) and w = gmx /
//    cnt (B, N, C), divided as the plain version divides it. Nothing is
//    added into memory another row writes.
//  * Pass 2, destination side (k6b_rows): a warp a destination j along
//    `order`. It loads 2 a[j] once, then walks j's edges in ascending e:
//    the edge ids 32 at a time (one load a lane, then shuffled), and for a
//    batch of edges (4 at C = 64, 2 at C = 128) the rows gs[i] and gsq[i]
//    and the edge's mask words in one round trip. At C = 128 w[i]'s row
//    comes with them; at C <= 64 w[i, c] is loaded after them, for the
//    tied channels only (a third fewer bytes, a second round trip): in
//    the pipeline each was the faster at its width, and a cp.async ring in
//    shared memory, which waits once an edge, was slower at both (PERF.md,
//    PR 13). Then it adds the terms in the plain version's rounding order:
//        t = gs + (2 a) gsq;  t = t + (tie ? w : 0);  acc = acc + t,
//    acc from +0. The CPU's index_add_ is a sequential sum in ascending
//    index order, so every destination gets the plain version's bits
//    (-fmad=false, and the intrinsics below, keep every product and sum
//    apart). The register cap (launch bounds) keeps 32 warps an SM in
//    flight.
//  * Skew: every destination's list is walked whole by one warp. The
//    trained encoder's graphs have in-degrees of at most 157 at K = 64
//    (PERF.md), so no list sets the pace. A graph whose hubs did would need
//    K5's plan (csrc/segsum.cu): fixed pieces of a list, added in order.
#include <cuda_runtime.h>

#include <cub/device/device_radix_sort.cuh>

#include "gather_rows.cuh"

namespace {

using gather_rows::FULL;
using gather_rows::KMAX;
using gather_rows::load_vec;
using gather_rows::store_vec;

constexpr int WARPS = gather_rows::WARPS;  // warps per block
constexpr int RUN = gather_rows::RUN;      // positions of the order a block

constexpr int THREADS = 256;  // the transpose's blocks

// Rows loaded ahead and blocks an SM (the register cap) of pass 1, and
// edges loaded ahead and blocks an SM of pass 2, by CJ = C / 32: chosen on
// the H100 at the layer shapes (PERF.md, PR 13).
__host__ __device__ constexpr int src_unroll(int cj) {
  return cj <= 2 ? 16 : (cj <= 4 ? 8 : 4);
}
__host__ __device__ constexpr int src_blocks(int cj) {
  return cj <= 2 ? 3 : (cj <= 4 ? 2 : 1);
}
__host__ __device__ constexpr int walk_unroll(int cj) {
  return cj <= 2 ? 4 : 2;
}
__host__ __device__ constexpr int walk_blocks(int cj) {
  return cj <= 4 ? 4 : 2;
}
// Pass 2 loads w's whole row with gs's and gsq's above C = 64, and w only
// for the tied channels, after the batch's mask, up to C = 64.
__host__ __device__ constexpr bool walk_w_row(int cj) { return cj > 2; }

// The transpose's keys and values: edge e = (b N + i) K + k has key
// b N + clamp(idx[e], 0, N - 1) and value e.
__global__ void __launch_bounds__(THREADS)
k6b_transpose_keys(const long long* __restrict__ idx, int n, int k,
                   int e_total, int* __restrict__ keys,
                   int* __restrict__ vals) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= e_total) return;
  const long long j = __ldg(idx + e);
  const int b = e / k / n;
  keys[e] = b * n + (j < 0 ? 0 : (j >= n ? n - 1 : (int)j));
  vals[e] = e;
}

// ends[d], the number of sorted keys <= d: position p ends destinations
// keys[p] .. keys[p + 1] - 1 (keys[E] = B N), and position 0 also writes 0
// for the destinations before keys[0].
__global__ void __launch_bounds__(THREADS)
k6b_transpose_ends(const int* __restrict__ keys, int e_total, int rows,
                   int* __restrict__ ends) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= e_total) return;
  const int d0 = __ldg(keys + p);
  const int d1 = p + 1 < e_total ? __ldg(keys + p + 1) : rows;
  for (int d = d0; d < d1; ++d) ends[d] = p + 1;
  if (p == 0)
    for (int d = 0; d < d0; ++d) ends[d] = 0;
}

// The transpose's scratch: keys and values before the sort, the sorted
// keys, and CUB's own temporary storage, each 256-byte aligned.
struct TransposeScratch {
  int *keys, *vals, *sorted;
  void* temp;
  size_t temp_bytes, total;
};

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

int key_bits(int rows) {
  int bits = 1;
  while (bits < 31 && (1LL << bits) < rows) ++bits;
  return bits;
}

TransposeScratch transpose_scratch(char* base, int e_total, int rows) {
  TransposeScratch t{};
  cub::DeviceRadixSort::SortPairs(nullptr, t.temp_bytes, (const int*)nullptr,
                                  (int*)nullptr, (const int*)nullptr,
                                  (int*)nullptr, e_total, 0, key_bits(rows));
  size_t off = 0;
  const size_t edge = align256((size_t)e_total * 4);
  t.keys = (int*)(base + off); off += edge;
  t.vals = (int*)(base + off); off += edge;
  t.sorted = (int*)(base + off); off += edge;
  t.temp = base + off; off += align256(t.temp_bytes);
  t.total = off;
  return t;
}

template <int CJ>
__device__ __forceinline__ void load_words(const unsigned* __restrict__ p,
                                           unsigned (&v)[CJ]) {
  if constexpr (CJ % 4 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 4; ++u) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + u);
      v[4 * u] = t.x; v[4 * u + 1] = t.y; v[4 * u + 2] = t.z; v[4 * u + 3] = t.w;
    }
  } else if constexpr (CJ % 2 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 2; ++u) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p) + u);
      v[2 * u] = t.x; v[2 * u + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < CJ; ++u) v[u] = __ldg(p + u);
  }
}

__device__ __forceinline__ int clamp_row(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Pass 1. For each row (b, i) along `order` (block x owns the positions
// [run * (x % runs), + run) of shape x / runs): the tie mask of its K edges
// and w[b, i] = gmx / cnt.
template <int CJ>
__global__ void __launch_bounds__(32 * WARPS, src_blocks(CJ))
k6b_sources(const float* __restrict__ a, const long long* __restrict__ idx,
            const int* __restrict__ order, const float* __restrict__ mx,
            const float* __restrict__ gmx, int n, int runs, int run, int k,
            unsigned* __restrict__ mask, float* __restrict__ w) {
  constexpr int C = 32 * CJ, SLOTS = KMAX / 32, UNR = src_unroll(CJ);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / runs;
  const int p0 = (blockIdx.x - b * runs) * run;
  const int p1 = min(p0 + run, n);
  const long long base = (long long)b * n;
  const float* table = a + base * C + lane * CJ;
  for (int p = p0 + (threadIdx.x >> 5); p < p1; p += WARPS) {
    const int i = order ? clamp_row(__ldg(order + base + p), n) : p;
    const long long row = base + i;
    const long long* ir = idx + row * k;
    unsigned off[SLOTS];  // j * C of the lane's neighbours (N C < 2^32)
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int kk = 32 * t + lane;
      const long long j = kk < k ? ir[kk] : 0;
      off[t] = (unsigned)(j < 0 ? 0 : (j >= n ? n - 1 : (int)j)) * C;
    }
    const long long o = row * C + lane * CJ;
    float m[CJ];
    int cnt[CJ];
    load_vec<CJ>(mx + o, m);
#pragma unroll
    for (int c = 0; c < CJ; ++c) cnt[c] = 0;
    unsigned* mrow = mask + row * k * CJ;  // the row's K CJ words
    const int last = k * CJ - 1;
    unsigned word = 0;  // the lane's word of the 32 being filled
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int count = min(32, k - 32 * t);  // warp-uniform
      for (int s0 = 0; s0 < count; s0 += UNR) {
        float v[UNR][CJ];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const unsigned oj =
              __shfl_sync(FULL, off[t], min(s0 + u, count - 1));
          load_vec<CJ>(table + oj, v[u]);
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          if (s0 + u < count) {
            const int w0 = (32 * t + s0 + u) * CJ;
#pragma unroll
            for (int c = 0; c < CJ; ++c) {
              const bool tie = v[u][c] == m[c];
              cnt[c] += tie;
              const unsigned bal = __ballot_sync(FULL, tie);
              const int wi = w0 + c;
              if ((wi & 31) == lane) word = bal;
              if ((wi & 31) == 31 || wi == last) {  // warp-uniform
                if (lane <= (wi & 31)) mrow[(wi & ~31) + lane] = word;
              }
            }
          }
        }
      }
    }
    float g[CJ];
    load_vec<CJ>(gmx + o, g);
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      g[c] = cnt[c] > 0 ? __fdiv_rn(g[c], (float)cnt[c]) : 0.0f;
    store_vec<CJ>(w + o, g);
  }
}

// acc (the lane's CJ channels of one destination, 2 a of it in a2) plus
// the terms of the edges at sorted positions [e0, e1), in ascending order.
// gs, gsq and w point at the lane's first channel of row 0. A batch of UNR
// edges' rows and mask words is loaded in one round trip; w either with
// them (its whole row) or after them (the tied channels only).
template <int CJ>
__device__ __forceinline__ void walk(const float (&a2)[CJ],
                                     const float* __restrict__ gs,
                                     const float* __restrict__ gsq,
                                     const float* __restrict__ w,
                                     const unsigned* __restrict__ mask,
                                     const int* __restrict__ eids, int e0,
                                     int e1, int k, float (&acc)[CJ]) {
  constexpr int C = 32 * CJ, UNR = walk_unroll(CJ);
  constexpr bool W_ROW = walk_w_row(CJ);
  const int lane = threadIdx.x & 31;
  for (int q = e0; q < e1; q += 32) {
    const int count = min(32, e1 - q);  // warp-uniform
    unsigned e = 0, r = 0;
    if (lane < count) {
      e = (unsigned)__ldg(eids + q + lane);
      r = e / (unsigned)k;  // the source row b N + i
    }
    for (int s0 = 0; s0 < count; s0 += UNR) {
      // every load unconditional (past the batch, its last edge again, not
      // added), so that the UNR edges' loads are in flight together
      float vs[UNR][CJ], vq[UNR][CJ], vw[UNR][CJ];
      unsigned bits[UNR][CJ];
      size_t ro[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int src = min(s0 + u, count - 1);
        const unsigned eu = __shfl_sync(FULL, e, src);
        ro[u] = (size_t)__shfl_sync(FULL, r, src) * C;
        load_vec<CJ>(gs + ro[u], vs[u]);
        load_vec<CJ>(gsq + ro[u], vq[u]);
        if constexpr (W_ROW) load_vec<CJ>(w + ro[u], vw[u]);
        load_words<CJ>(mask + (size_t)eu * CJ, bits[u]);
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {  // tie ? w : 0
          const bool tie = (bits[u][c] >> lane) & 1u;
          if constexpr (W_ROW) vw[u][c] = tie ? vw[u][c] : 0.0f;
          else vw[u][c] = tie ? __ldg(w + ro[u] + c) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (s0 + u < count) {
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            float t = __fadd_rn(vs[u][c], __fmul_rn(a2[c], vq[u][c]));
            t = __fadd_rn(t, vw[u][c]);
            acc[c] = __fadd_rn(acc[c], t);
          }
        }
      }
    }
  }
}

// Pass 2. For each destination (b, j) along `order` (blocks as in pass 1):
// its edges in ascending order, da[b, j] written once.
template <int CJ>
__global__ void __launch_bounds__(32 * WARPS, walk_blocks(CJ))
k6b_rows(const float* __restrict__ a, const int* __restrict__ order,
         const float* __restrict__ gs, const float* __restrict__ gsq,
         const float* __restrict__ w, const unsigned* __restrict__ mask,
         const int* __restrict__ ends, const int* __restrict__ eids, int n,
         int runs, int run, int k, float* __restrict__ da) {
  constexpr int C = 32 * CJ;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / runs;
  const int p0 = (blockIdx.x - b * runs) * run;
  const int p1 = min(p0 + run, n);
  const long long base = (long long)b * n;
  for (int p = p0 + (threadIdx.x >> 5); p < p1; p += WARPS) {
    const int j = order ? clamp_row(__ldg(order + base + p), n) : p;
    const long long d = base + j;
    const int e0 = d ? __ldg(ends + d - 1) : 0;
    const int e1 = __ldg(ends + d);
    float a2[CJ], acc[CJ];
    load_vec<CJ>(a + d * C + lane * CJ, a2);
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      a2[c] = __fmul_rn(2.0f, a2[c]);
      acc[c] = 0.0f;
    }
    walk<CJ>(a2, gs + lane * CJ, gsq + lane * CJ, w + lane * CJ, mask, eids,
             e0, e1, k, acc);
    store_vec<CJ>(da + d * C + lane * CJ, acc);
  }
}

template <int CJ>
int launch_width(const float* a, const long long* idx, const int* order,
                 const float* mx, const float* gs, const float* gsq,
                 const float* gmx, const int* ends, const int* eids,
                 int batch, int n, int k, unsigned* mask, float* w, float* da,
                 cudaStream_t stream) {
  const int runs = (n + RUN - 1) / RUN;
  const long long blocks = (long long)batch * runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k6b_sources<CJ><<<(unsigned)blocks, 32 * WARPS, 0, stream>>>(
      a, idx, order, mx, gmx, n, runs, RUN, k, mask, w);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  k6b_rows<CJ><<<(unsigned)blocks, 32 * WARPS, 0, stream>>>(
      a, order, gs, gsq, w, mask, ends, eids, n, runs, RUN, k, da);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch bytes of sednet_graph_transpose for B N K edges and B N rows.
extern "C" long long sednet_graph_transpose_scratch(long long e_total,
                                                    int rows) {
  if (e_total < 1 || e_total > 0x7fffffffLL || rows < 1) return -1;
  return (long long)transpose_scratch(nullptr, (int)e_total, rows).total;
}

// The graph's transpose: idx (B, N, K) int64 (entries clamped into [0, N)
// within their shape), B N K < 2^31. eids (B N K) int32: the edge ids e =
// (b N + i) K + k sorted by destination b N + j, ascending within a
// destination (CUB's stable radix sort on the bits of B N - 1 alone); ends
// (B N) int32: each destination's inclusive end. scratch:
// sednet_graph_transpose_scratch bytes. Launches on `stream`, no
// synchronisation.
extern "C" int sednet_graph_transpose(const void* idx, int batch, int n,
                                      int k, void* scratch,
                                      long long scratch_bytes, void* ends,
                                      void* eids, void* stream) {
  const long long e_ll = (long long)batch * n * k;
  if (batch < 1 || n < 1 || k < 1 || e_ll > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int e_total = (int)e_ll, rows = batch * n;
  TransposeScratch t = transpose_scratch((char*)scratch, e_total, rows);
  if ((long long)t.total > scratch_bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  k6b_transpose_keys<<<(e_total + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const long long*)idx, n, k, e_total, t.keys, t.vals);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  size_t bytes = t.temp_bytes;
  rc = (int)cub::DeviceRadixSort::SortPairs(t.temp, bytes, t.keys, t.sorted,
                                            t.vals, (int*)eids, e_total, 0,
                                            key_bits(rows), st);
  if (rc) return rc;
  k6b_transpose_ends<<<(e_total + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      t.sorted, e_total, rows, (int*)ends);
  return (int)cudaGetLastError();
}

// a, mx, gs, gsq, gmx: (B, N, C) float32, C a multiple of 32 up to 256,
// N C < 2^32, 16-byte aligned; idx: (B, N, K) int64, 1 <= K <= 128, B N K
// < 2^31 (out-of-range entries clamp into [0, N)); order: (B, N) int32, a
// permutation of each shape's rows, or null for the identity; ends (B N)
// and eids (B N K): int32, the transpose (ops/graph.py graph_transpose).
// Scratch: mask (B N K C / 32) 32-bit words and w (B, N, C) float32. da:
// (B, N, C) float32, every element written. Two launches on `stream`, no
// synchronisation.
extern "C" int sednet_gather_reduce_backward(
    const void* a, const void* idx, const void* order, const void* mx,
    const void* gs, const void* gsq, const void* gmx, const void* ends,
    const void* eids, int batch, int n, int c, int k, void* mask, void* w,
    void* da, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > KMAX || c < 32 || c > 256 ||
      c % 32 != 0 || (long long)batch * n * k > 0x7fffffffLL ||
      (long long)n * c > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;
#define GATHER_BWD_CASE(CJ)                                                  \
  case CJ:                                                                   \
    return launch_width<CJ>(                                                 \
        (const float*)a, (const long long*)idx, (const int*)order,           \
        (const float*)mx, (const float*)gs, (const float*)gsq,               \
        (const float*)gmx, (const int*)ends, (const int*)eids, batch, n, k,  \
        (unsigned*)mask, (float*)w, (float*)da, (cudaStream_t)stream);
  switch (c / 32) {
    GATHER_BWD_CASE(1)
    GATHER_BWD_CASE(2)
    GATHER_BWD_CASE(3)
    GATHER_BWD_CASE(4)
    GATHER_BWD_CASE(5)
    GATHER_BWD_CASE(6)
    GATHER_BWD_CASE(7)
    GATHER_BWD_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GATHER_BWD_CASE
}
