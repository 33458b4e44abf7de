// Per-destination sums of entries sorted by destination: the A^T v of the
// matrix-free spectral LOBPCG (cluster/spectral.py, transpose_mode "pallas").
//
// Replaces the TPU kernel segsum_sorted_scan_pallas of
// sednet_tpu/ops/pallas_kernels.py (`_segsum_scan_kernel`, method "roll",
// and `_segsum_mxu_kernel`, method "mxu"). For every destination d < N and
// row r < m, with ends[-1] = 0:
//
//   out[d, r] = sum_{e in [ends[d-1], ends[d])} vals_t[r, e]
//
// and exactly 0 for an empty destination. Every partial sum is a plain
// pairwise add of entries: no prefix difference (the quirk affinity's
// coefficients span about 1e6, and a cumsum difference loses them), and no
// float atomics, so two launches give bit-identical results.
//
// What bounds it on the H100: bytes. It reads vals_t once (m * E floats:
// 236 MB at m = 36, 79 MB at m = 12, for N = 32768 and 50 neighbours,
// E = 1638400) and writes N * m floats: 0.072 / 0.024 ms at 3.35 TB/s.
//
// Design. The farthest quirk gives a few hundred of the N destinations all
// the entries, up to 11255 each, and leaves the rest empty. The first
// design gave each destination a block, which left one block walking the
// longest segment while the other SMs idled. Here the work is split over
// the entries: block c takes the chunk [c CHUNK, (c + 1) CHUNK) of E (800
// chunks at E = 1.64M). Its threads find the pieces of the segments that
// touch the chunk by binary search in `ends` from their own entries, so
// that no loop runs over empty destinations (a few blocks that owned long
// runs of them, zeroing them one by one, were the tail of this design's
// first version; PERF.md). Then, row by row, each warp
// loads its 256 entries of the row (16-byte loads, the whole block 8 KB of
// one row at once, the next row's loads in flight while this one is
// added), each lane adds its entries of each piece in ascending order, a
// fixed butterfly of shuffles adds the lanes, and the warps' sums are added
// in warp order. A segment inside the chunk goes to `out`; a piece of a
// segment that crosses the chunk's edges goes to scratch (`first`: the
// piece of the segment that began in an earlier chunk; `last`: the piece of
// the one that goes on past the chunk). A second launch writes 0 to the
// empty destinations, one thread an output, and adds each crossing
// segment's pieces in chunk order, one warp a segment and row, loading 32
// pieces at a time. The order of every add is fixed by the chunk plan and
// the segment bounds alone. `dest` is not read: the bounds come from `ends`.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 2048;          // entries per block
constexpr int SPAN = CHUNK / WARPS;  // entries per warp: two quads a lane
constexpr unsigned FULL = 0xffffffffu;

// First i in [0, n) with ends[i] > v, n if none: the destination of entry
// v (empty destinations skipped).
__device__ int upper_bound(const int* __restrict__ ends, int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] > v) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// The two quads of a row that lane `lane` of warp `warp` owns in the chunk
// at c0: entries c0 + SPAN warp + 128 h + 4 lane + (0 .. 3), h = 0, 1. VEC:
// one 16-byte load a quad (row + c0 16-byte aligned), else four scalar
// loads; entries past E are not read (and never added).
template <bool VEC>
__device__ __forceinline__ void load_quads(const float* __restrict__ row,
                                           long long q0, long long e_total,
                                           float4 (&v)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long q = q0 + 128 * h;
    if (q >= e_total) {
      v[h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // never added
    } else if (VEC && q + 3 < e_total) {
      v[h] = __ldg(reinterpret_cast<const float4*>(row + q));
    } else {
      v[h].x = __ldg(row + min(q, e_total - 1));
      v[h].y = __ldg(row + min(q + 1, e_total - 1));
      v[h].z = __ldg(row + min(q + 2, e_total - 1));
      v[h].w = __ldg(row + min(q + 3, e_total - 1));
    }
  }
}

// Pass 1: block c sums, row by row, the pieces of the segments that touch
// chunk c. A segment wholly inside goes to out, the piece of the segment
// that began before the chunk to first[c], the piece of the one that goes
// on past it to last[c] (with its destination in cross[c], else -1). Empty
// destinations are pass 2's.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
segsum_pieces(const float* __restrict__ vals_t, const int* __restrict__ ends,
              int m, long long e_total, int n, int chunks,
              float* __restrict__ first, float* __restrict__ last,
              int* __restrict__ cross, float* __restrict__ out) {
  constexpr int PER = CHUNK / THREADS;  // entries a thread searches
  __shared__ int dest[CHUNK];             // the pieces, in entry order
  __shared__ short lo[CHUNK], hi[CHUNK];  // their bounds, from c0
  __shared__ int wsum[WARPS], wfirst[WARPS], wnum[WARPS];
  __shared__ float part[2][WARPS][SPAN];  // warp sums of a row's pieces
  const int c = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long c0 = (long long)c * CHUNK;
  const long long c1 = min(c0 + CHUNK, e_total);

  // Thread t lists the pieces whose first entry in the chunk lies in its
  // PER entries, by binary search in ends; a block scan puts them in entry
  // order.
  int pd[PER], plo[PER], phi[PER];
  int np = 0;
  {
    const long long pa = c0 + PER * t, pb = min(pa + PER, c1);
    long long p = pa;
    while (p < pb) {
      const int d = upper_bound(ends, n, p);
      if (d >= n) break;  // past the last segment
      const long long s = d ? ends[d - 1] : 0;
      const long long e = ends[d];
      const long long a = max(s, c0);
      if (a >= pa) {  // the piece starts here (or at c0, the chunk's head)
        pd[np] = d;
        plo[np] = (int)(a - c0);
        phi[np] = (int)(min(e, c1) - c0);
        ++np;
      }
      p = e;
    }
  }
  int incl = np;  // block-wide exclusive scan of np
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int at = incl - np;
  for (int w = 0; w < warp; ++w) at += wsum[w];
  int count = 0;
  for (int w = 0; w < WARPS; ++w) count += wsum[w];
  for (int i = 0; i < np; ++i) {
    dest[at + i] = pd[i];
    lo[at + i] = (short)plo[i];
    hi[at + i] = (short)phi[i];
  }
  __syncthreads();
  if (t == 0) {
    int x = -1;
    if (count > 0) {
      const int d = dest[count - 1];
      if (ends[d] > c1 && (d ? ends[d - 1] : 0) >= c0) x = d;
    }
    cross[c] = x;
  }
  // the pieces that meet each warp's span [SPAN w, SPAN (w + 1))
  if (lane == 0) {
    int q = 0;
    while (q < count && hi[q] <= SPAN * warp) ++q;
    int k = q;
    while (k < count && lo[k] < SPAN * (warp + 1)) ++k;
    wfirst[warp] = q;
    wnum[warp] = k - q;
  }
  __syncthreads();

  const int qf = wfirst[warp], qn = wnum[warp];
  const int e0 = SPAN * warp + 4 * lane;  // the lane's first entry, from c0
  float4 v[2];
  int r = c % m;  // rows rotated by the chunk
  load_quads<VEC>(vals_t + (long long)r * e_total, c0 + e0, e_total, v);
  for (int i = 0; i < m; ++i) {
    float* wp = part[i & 1][warp];
    // each piece of the warp's span: the lane adds its entries in the piece
    // in ascending order, a butterfly adds the lanes
    for (int q = 0; q < qn; ++q) {
      const int a = lo[qf + q], b = hi[qf + q];
      float acc = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = e0 + 128 * h;
        if (x >= a && x < b) acc = acc + v[h].x;
        if (x + 1 >= a && x + 1 < b) acc = acc + v[h].y;
        if (x + 2 >= a && x + 2 < b) acc = acc + v[h].z;
        if (x + 3 >= a && x + 3 < b) acc = acc + v[h].w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = acc + __shfl_xor_sync(FULL, acc, off);
      if (lane == 0) wp[q] = acc;
    }
    const int row_now = r;
    if (i + 1 < m) {  // the next row's loads in flight over the merge
      r = r + 1 == m ? 0 : r + 1;
      load_quads<VEC>(vals_t + (long long)r * e_total, c0 + e0, e_total, v);
    }
    __syncthreads();
    // each piece: the warp sums in warp order
    for (int q = t; q < count; q += THREADS) {
      float sum = 0.0f;
      bool any = false;
      for (int w = 0; w < WARPS; ++w) {
        const int k = q - wfirst[w];
        if (k >= 0 && k < wnum[w]) {
          const float x = part[i & 1][w][k];
          sum = any ? sum + x : x;
          any = true;
        }
      }
      const int d = dest[q];
      if (lo[q] == 0 && (d ? ends[d - 1] : 0) < c0)
        first[(long long)c * m + row_now] = sum;
      else if (ends[d] > c1)
        last[(long long)c * m + row_now] = sum;
      else
        out[(long long)d * m + row_now] = sum;
    }
  }
}

// Pass 2: thread x writes 0 to out[x] (x < N m) when destination x / m is
// empty, and warp w (< chunks m) completes the segment that starts in chunk
// c = w / m and goes on past it, at row w % m: the sum of its pieces, left
// to right, last[c] + first[c + 1] + ... . The lanes load 32 pieces at a
// time and every lane adds them in chunk order through shuffles, so a
// segment that spans hundreds of chunks waits on one load a 32 pieces.
__global__ void __launch_bounds__(THREADS)
segsum_merge(const int* __restrict__ ends, int m, int n, int chunks,
             const float* __restrict__ first, const float* __restrict__ last,
             const int* __restrict__ cross, float* __restrict__ out) {
  const long long x = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (x < (long long)n * m) {
    const int d = (int)(x / m);
    if (ends[d] <= (d ? ends[d - 1] : 0)) out[x] = 0.0f;
  }
  const long long w = x >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= (long long)chunks * m) return;  // the whole warp
  const int c = (int)(w / m), r = (int)(w % m);
  const int d = cross[c];
  if (d < 0) return;
  // the chunks c2 with c2 * CHUNK < ends[d] hold a piece of segment d
  const int cend = (int)min((long long)chunks,
                            ((long long)ends[d] + CHUNK - 1) / CHUNK);
  float acc = last[(long long)c * m + r];
  for (int c2 = c + 1; c2 < cend; c2 += 32) {
    const int mine = c2 + lane;
    const float v = mine < cend ? first[(long long)mine * m + r] : 0.0f;
    const int count = min(32, cend - c2);
    for (int i = 0; i < count; ++i) acc = acc + __shfl_sync(FULL, v, i);
  }
  if (lane == 0) out[(long long)d * m + r] = acc;
}

int chunk_count(long long e) {
  return e <= 0 ? 1 : (int)((e + CHUNK - 1) / CHUNK);
}

}  // namespace

// The number of chunks of E entries: the scratch of sednet_segsum_sorted is
// 2 * chunks * m floats and chunks ints.
extern "C" int sednet_segsum_chunks(long long e) { return chunk_count(e); }

// vals_t: (m, E) float32; ends: (N,) int32 ascending cumulative counts,
// ends[N-1] <= E; out: (N, m) float32; scratch_f: 2 * chunks * m float32,
// scratch_i: chunks int32 (chunks = sednet_segsum_chunks(E)). Two launches
// on `stream`, no synchronisation.
extern "C" int sednet_segsum_sorted(const void* vals_t, const void* ends,
                                    int m, long long e, int n, void* out,
                                    void* scratch_f, void* scratch_i,
                                    void* stream) {
  if (m < 1 || n < 1 || e < 0) return (int)cudaErrorInvalidValue;
  const long long chunks = chunk_count(e);
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* first = (float*)scratch_f;
  float* last = first + chunks * m;
  int* cross = (int*)scratch_i;
  const bool vec = e % 4 == 0 && ((uintptr_t)vals_t & 15) == 0;
  (vec ? segsum_pieces<true> : segsum_pieces<false>)<<<
      (unsigned)chunks, THREADS, 0, st>>>(
      (const float*)vals_t, (const int*)ends, m, e, n, (int)chunks, first,
      last, cross, (float*)out);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // a thread an output, a warp a (chunk, row)
  const long long threads = max((long long)n * m, 32 * chunks * m);
  if ((threads + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  segsum_merge<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0,
                 st>>>((const int*)ends, m, n, (int)chunks, first, last,
                       cross, (float*)out);
  return (int)cudaGetLastError();
}
