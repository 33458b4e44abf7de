// Warp-wide selection of a row's k best (value, column) pairs, kept in
// registers: the selection of the exact top-k (K1, flash_topk.cu) and of
// the fused edge-conv reductions (K4, fused_edgeconv.cu), both through the
// column walk of knn_walk.cuh.
//
// A warp holds a row's list of KP = 32 * KPL best pairs, ascending, entry
// e = 32 * j + lane in register j of that lane. Pairs are ordered
// lexicographically by (value, column): every key is distinct, so the KP
// smallest of any set of candidates do not depend on the order in which
// they arrive, exact ties go to the lower column, and partial lists of
// disjoint column ranges merge into the same answer in any order.
//
// Two operations, all over shuffles, no shared memory and no barrier:
//   add_sorted      32 or 64 candidates at once: a bitonic sort of them,
//                   then a bitonic merge into the list;
//   merge_reversed  another sorted list of KP (read reversed by the caller).
// Each returns the least value it pushed out of the list, from which K4
// learns whether a column outside the k best ties the k-th value.
// The caller keeps the threshold, the value of the list's k-th pair, and
// queues a candidate only when it is not above it; the queue joins the
// list 64 at a time. Once the list is full, a candidate costs one compare
// and one ballot.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn_select {

constexpr int NO_COL = 0x7fffffff;   // column of an empty entry (+inf)

// The networks below loop over log2 of their strides, so that every loop
// has a constant trip count, unrolls, and keeps the lists in registers.
__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// (a, ia) < (b, ib) in the (value, column) order
__device__ __forceinline__ bool lt(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// The value of entry e of the list, broadcast to every lane (e
// warp-uniform).
template <int KPL>
__device__ __forceinline__ float value_at(const float (&v)[KPL], int e) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < KPL; ++j)
    if ((e >> 5) == j) x = v[j];
  return __shfl_sync(0xffffffffu, x, e & 31);
}

// One compare-exchange of a bitonic network across lanes at distance s:
// this lane keeps the smaller pair if keep_min, else the larger.
__device__ __forceinline__ void exchange(float& v, int& ix, int s,
                                         bool keep_min) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, s);
  const int oi = __shfl_xor_sync(0xffffffffu, ix, s);
  const bool take = keep_min ? lt(ov, oi, v, ix) : lt(v, ix, ov, oi);
  if (take) {
    v = ov;
    ix = oi;
  }
}

// Sort a bitonic list ascending (bitonic merge): register strides first,
// then lane strides.
template <int KPL>
__device__ __forceinline__ void bitonic_merge(float (&v)[KPL],
                                              int (&ix)[KPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < log2i(KPL); ++i) {
    const int sj = KPL >> (i + 1);
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if ((j & sj) == 0 && lt(v[j + sj], ix[j + sj], v[j], ix[j])) {
        const float tv = v[j];
        const int ti = ix[j];
        v[j] = v[j + sj];
        ix[j] = ix[j + sj];
        v[j + sj] = tv;
        ix[j + sj] = ti;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
#pragma unroll
    for (int j = 0; j < KPL; ++j) exchange(v[j], ix[j], s, (lane & s) == 0);
  }
}

// Sort QP = 32 * QPL pairs ascending (bitonic sort), entry e = 32 j + lane
// in register j.
template <int QPL>
__device__ __forceinline__ void bitonic_sort(float (&v)[QPL], int (&ix)[QPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ls = 1; ls <= log2i(32 * QPL); ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int i = 0; i < ls; ++i) {
      const int s = size >> (i + 1);
      if (s >= 32) {   // between registers
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
          const int sj = s / 32, o = j + sj;
          if ((j & sj) == 0 && o < QPL) {
            const bool asc = ((32 * j) & size) == 0;
            if (lt(v[o], ix[o], v[j], ix[j]) == asc) {
              const float tv = v[j];
              const int ti = ix[j];
              v[j] = v[o];
              ix[j] = ix[o];
              v[o] = tv;
              ix[o] = ti;
            }
          }
        }
      } else {   // between lanes
#pragma unroll
        for (int j = 0; j < QPL; ++j)
          exchange(v[j], ix[j], s,
                   ((lane & s) == 0) == (((32 * j + lane) & size) == 0));
      }
    }
  }
}

// Add QP = 32 * QPL candidates ((inf, NO_COL) where there is none), QPL <=
// KPL: sort them ascending, put them reversed against the list's last QP
// entries keeping the smaller of each pair (the list stays the KP smallest
// of both, now bitonic), and merge. Returns the least value of the pairs
// this lane dropped (+inf if none): a caller that needs to know whether a
// dropped pair ties the k-th value takes the warp's min of it; the others
// ignore it and the compiler drops its arithmetic.
template <int KPL, int QPL>
__device__ __forceinline__ float add_sorted(float (&v)[KPL], int (&ix)[KPL],
                                            float (&cv)[QPL],
                                            int (&ci)[QPL]) {
  const int lane = threadIdx.x & 31;
  bitonic_sort(cv, ci);
  float low = CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < QPL; ++j) {
    const float rv = __shfl_sync(0xffffffffu, cv[QPL - 1 - j], 31 - lane);
    const int ri = __shfl_sync(0xffffffffu, ci[QPL - 1 - j], 31 - lane);
    const int o = KPL - QPL + j;
    if (lt(rv, ri, v[o], ix[o])) {
      low = fminf(low, v[o]);
      v[o] = rv;
      ix[o] = ri;
    } else {
      low = fminf(low, rv);
    }
  }
  bitonic_merge(v, ix);
  return low;
}

// Merge another ascending list of KP whose entry KP - 1 - e this lane has
// read into (rv[j], ri[j]) for its own entry e = 32 j + lane. Returns the
// least value of the pairs this lane dropped, as add_sorted does.
template <int KPL>
__device__ __forceinline__ float merge_reversed(float (&v)[KPL],
                                                int (&ix)[KPL],
                                                const float (&rv)[KPL],
                                                const int (&ri)[KPL]) {
  float low = CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < KPL; ++j)
    if (lt(rv[j], ri[j], v[j], ix[j])) {
      low = fminf(low, v[j]);
      v[j] = rv[j];
      ix[j] = ri[j];
    } else {
      low = fminf(low, rv[j]);
    }
  bitonic_merge(v, ix);
  return low;
}

// The least of a value over the warp, in every lane.
__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

}  // namespace knn_select
