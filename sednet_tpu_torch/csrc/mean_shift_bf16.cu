// One gaussian mean-shift step on the unit sphere with bf16 tile inputs,
// for a batch of shapes (the kernel of mean_shift.cuh): the `bf16=True`
// branch of the TPU kernels `_ms_kernel` (mean_shift_step_pallas) and
// `_ms_kernel_batched` (mean_shift_step_pallas_batched) of
// sednet_tpu/ops/pallas_kernels.py (config.ms_bf16). The wrapper rounds
// new_x and x to bf16 (round to nearest even, as JAX's astype does); then,
// for every shape b and query row i:
//
//   s[i, c]  = q_i . x_c, the bf16 products summed in float32
//   k[i, c]  = exp(max((s[i, c] - 1) * inv_b2[b], -75))        (c < n)
//   den[i]   = sum_c k[i, c]                          (float32, unrounded)
//   num[i]   = sum_c bf16(k[i, c]) x_c                (float32 sums)
//   out[i]   = rownorm(num[i] / max(den[i], 1e-30))
//
// with the row norm taken as sqrt(max(|v|^2, 1e-24)): the Pallas body with
// dt = bfloat16, where k is cast to x's type before the second product and
// summed before the cast.
//
// Bound on the H100: operations. 4*B*N*N*E flops on the bf16 tensor cores
// (989 TFLOP/s dense), 0.41 ms at (8, 10000, 128), a sixth of the bound of
// the three-term TF32 split (mean_shift.cu: three products at half the
// rate); beside them B*N*N exps, which the SFUs issue at 16 a cycle an SM
// (0.19 ms at (8, 10000) on 132 SMs at 1.98 GHz), and 3*B*N*E*4 bytes.
//
// Design: the kernel of mean_shift.cuh (the float32 step's walk over the
// tiles, cluster reduction and normalisation) with the tile products below.
// The tiles are bf16 in shared memory at a stride of E + 8 halves, so every
// 32-bit fragment load of a warp hits 32 banks. One mma.sync.m16n8k16 (bf16
// in, f32 out) per 16-deep k-step replaces the three TF32 products of the
// split:
//   * S = Q.X^T: A (g, 2t..2t+1 | +8) from the query rows, B (2t..2t+1 |
//     +8, g) from the tile rows, both 32-bit loads of two bf16;
//   * P = exp(...) stays in the registers of S's C fragments, den sums it
//     in float32, and it is rounded to bf16 in pairs: the C fragments of
//     n-tiles 2ks and 2ks + 1 are exactly the A fragment of k-step ks of
//     P.X (flash attention's register reuse, no permutation);
//   * num += P.X: B (k = c, n = e) pairs two tile rows of one column, two
//     16-bit loads packed into a register.
// Every mma starts from a zero fragment and is added to its sum on the CUDA
// cores, which round to nearest, so no tensor-core accumulator chains more
// than one 16-deep product. After the walk the float32 partial num (256
// (E + 4) bytes) takes the tiles' shared memory (256 (E + 8) bytes) and a
// little past it. Widths as for the float32 kernel (bf16 mma needs a
// multiple of 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mean_shift.cuh"

namespace {

using namespace sim_tile;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_rows(const __nv_bfloat16* p,
                                              int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Bf16Tile {
  using T = __nv_bfloat16;

  template <int E>
  __host__ __device__ static constexpr int pitch() { return E + 8; }  // halves

  // 16 bytes (8 halves) a copy
  template <int E>
  __device__ __forceinline__ static void load(T* dst, const T* src, int r0,
                                              int rows, int n) {
    constexpr int CHUNKS = E / 8;
    for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, ch = i % CHUNKS;
      const int gr = r0 + r;
      const bool valid = gr < n;
      cp_async16(reinterpret_cast<float*>(dst + r * pitch<E>() + 8 * ch),
                 reinterpret_cast<const float*>(
                     src + (size_t)(valid ? gr : 0) * E + 8 * ch),
                 valid);
    }
  }

  template <int E>
  __device__ __forceinline__ static void products(
      const T* qw, const T* xt, int g, int t, int c0, int n, float ib2,
      float (&num)[E / 8][4], float (&den)[2]) {
    constexpr int H = pitch<E>();

    // S = Q.X^T, one zero-started mma a k-step, summed on the CUDA cores
    float sim[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) sim[j][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk) {
      const T* pa = qw + g * H + 16 * kk + 2 * t;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * H), ld32(pa + 8),
                             ld32(pa + 8 * H + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* pb = xt + (8 * j + g) * H + 16 * kk + 2 * t;
        const uint32_t bb[2] = {ld32(pb), ld32(pb + 8)};
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, a, bb);
#pragma unroll
        for (int v = 0; v < 4; ++v) sim[j][v] += d[v];
      }
    }

    // P: C slot v is row g + 8 (v >> 1), column 8 j + 2t + (v & 1)
    float w[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = c0 + 8 * j + 2 * t + (v & 1);
        w[j][v] = c < n ? expf(fmaxf((sim[j][v] - 1.f) * ib2, -75.f)) : 0.f;
        den[v >> 1] += w[j][v];
      }
    uint32_t pa[CB / 16][4];
#pragma unroll
    for (int ks = 0; ks < CB / 16; ++ks) {
      pa[ks][0] = pack_bf16(w[2 * ks][0], w[2 * ks][1]);
      pa[ks][1] = pack_bf16(w[2 * ks][2], w[2 * ks][3]);
      pa[ks][2] = pack_bf16(w[2 * ks + 1][0], w[2 * ks + 1][1]);
      pa[ks][3] = pack_bf16(w[2 * ks + 1][2], w[2 * ks + 1][3]);
    }

    // num += P.X, this tile's sum in a zero-started fragment
#pragma unroll
    for (int et = 0; et < E / 8; ++et) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < CB / 16; ++ks) {
        const T* pb = xt + (16 * ks + 2 * t) * H + 8 * et + g;
        const uint32_t bb[2] = {pack_rows(pb, H), pack_rows(pb + 8 * H, H)};
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, pa[ks], bb);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] += d[v];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) num[et][v] += acc[v];
    }
  }
};

}  // namespace

// q, x: (B, N, E) bf16 contiguous, E a multiple of 32 up to 256; inv_b2:
// (B,) float32; out: (B, N, E) float32 contiguous.
extern "C" int sednet_mean_shift_step_bf16(const void* q, const void* x,
                                           const void* inv_b2, int batch,
                                           int n, int e, void* out,
                                           void* stream) {
  return mean_shift::launch_width<Bf16Tile>(q, x, inv_b2, batch, n, e, out,
                                            stream);
}
