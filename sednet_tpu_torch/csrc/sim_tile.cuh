// Building blocks shared by the mean-shift step (mean_shift.cu, K2/K2b) and
// the NMS column-max (colmax.cu, K3): a float32 product on the tensor cores
// by a three-term TF32 split, cp.async tile loads, and the cluster layout
// both kernels use.
//
// Bound: the three products for each f32 one over the dense TF32 peak, 495
// TFLOP/s, where the f32 CUDA cores allow 67; the kernels' notes give the
// figures. On an H100 80GB HBM3 at 700 W they run at 4.0-5.8x it: each
// warp splits every fragment it loads, so the CUDA cores issue several
// instructions for each mma, and short mma chains keep few products in
// flight (more independent accumulators measured faster; see PERF.md).
//
// The split. Each operand a is cut into hi = tf32(a) and lo = tf32(a - hi)
// (round to nearest, ties away, as cvt.rna.tf32.f32 does, here by two
// integer operations on the bits: add half a TF32 ulp, clear the 13 low
// bits; the same result for every finite input, without cvt's special-value
// handling; a - hi is exact in f32), and a.b is taken as
// lo.hi + hi.lo + hi.hi with every product exact and f32 sums: CUTLASS's
// 3xTF32 (OpMultiplyAddFastF32), written out here with mma.sync. The
// dropped lo.lo and the rounding of lo are each below 2^-22 of |a||b|,
// about what f32 rounding leaves. The tensor cores truncate when they add
// into an accumulator, so no accumulator runs long: a product over a width
// of E is summed KC k-steps at a time into fresh fragments, one for each
// of the three terms (three independent chains of mma.sync, not one chain
// three times as long), and those are added on the CUDA cores, which round
// to nearest.
//
// Fragments of mma.sync.m16n8k8 (tf32 in, f32 out), g = lane / 4 and
// t = lane % 4: A (16 x 8, row major) a0 = (g, t), a1 = (g + 8, t),
// a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8, k by n) b0 = (t, g),
// b1 = (t + 4, g); C (16 x 8) c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8,
// 2t), c3 = (g + 8, 2t + 1). Both operands of a similarity tile are rows of
// width E in shared memory at a stride of E + 4 words, so each fragment
// load of a warp hits 32 different banks.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sim_tile {

namespace cg = cooperative_groups;

constexpr int RB = 64;        // rows of a cluster, 16 for each of 4 warps
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CB = 32;        // columns per pipeline stage
constexpr int NT = CB / 8;    // 8-column n-tiles per stage
constexpr int STAGES = 2;     // cp.async stages: the next tile lands meanwhile
constexpr int SPLIT = 4;      // blocks of a cluster, a quarter of columns each
constexpr int ROWS_OUT = RB / SPLIT;   // rows each block of a cluster finishes
constexpr int KC = 2;         // k-steps summed in one fresh fragment

template <int E>
__host__ __device__ constexpr int stride() { return E + 4; }

__device__ __forceinline__ uint32_t tf32_bits(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(a);
  lo = tf32_bits(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(PENDING) : "memory");
}

// Rows [r0, r0 + rows) of a (n, E) row-major array into shared memory at
// stride E + 4, rows at or past n as zeros. One 16-byte copy per thread
// and step; the caller commits the group.
template <int E>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows, int n) {
  constexpr int CHUNKS = E / 4;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    const int gr = r0 + r;
    const bool valid = gr < n;
    cp_async16(dst + r * stride<E>() + 4 * ch,
               src + (size_t)(valid ? gr : 0) * E + 4 * ch, valid);
  }
}

// The A fragment of the 16 rows at `rows` (stride E + 4), k-step kk.
template <int E>
__device__ __forceinline__ void load_a(const float* rows, int kk, int g,
                                       int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  constexpr int S = stride<E>();
  const float* p = rows + g * S + 8 * kk + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * S], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * S + 4], hi[3], lo[3]);
}

// sim[j] (the C fragments of n-tile j) = the 16 rows at `rows` against the
// CB columns at `cols`, both of width E at stride E + 4.
template <int E>
__device__ __forceinline__ void similarity(const float* rows,
                                           const float* cols, int g, int t,
                                           float (&sim)[NT][4]) {
  constexpr int S = stride<E>();
  static_assert(E % (8 * KC) == 0, "width must be a multiple of 8 * KC");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) sim[j][v] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < E / 8; k0 += KC) {
    float lohi[NT][4], hilo[NT][4], hihi[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) lohi[j][v] = hilo[j][v] = hihi[j][v] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + KC; ++kk) {
      uint32_t ahi[4], alo[4];
      load_a<E>(rows, kk, g, t, ahi, alo);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = cols + (8 * j + g) * S + 8 * kk + t;
        uint32_t bhi[2], blo[2];
        split(p[0], bhi[0], blo[0]);
        split(p[4], bhi[1], blo[1]);
        mma(lohi[j], alo, bhi);
        mma(hilo[j], ahi, blo);
        mma(hihi[j], ahi, bhi);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        sim[j][v] += (lohi[j][v] + hilo[j][v]) + hihi[j][v];
  }
}

// True when p is 16-byte aligned, as cp.async needs.
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace sim_tile
