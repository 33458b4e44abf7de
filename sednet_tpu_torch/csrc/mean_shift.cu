// One gaussian mean-shift step on the unit sphere, for a batch of shapes, in
// float32: the kernel of mean_shift.cuh with the tile products below.
//
// Replaces the TPU kernels `_ms_kernel` (mean_shift_step_pallas) and
// `_ms_kernel_batched` (mean_shift_step_pallas_batched) of
// sednet_tpu/ops/pallas_kernels.py.
//
// Bound on the H100: operations. A call does two products of N x N x E
// per shape, 4*B*N*N*E flops, against 3*B*N*E floats of traffic. Both run
// on the tensor cores by the three-term TF32 split of sim_tile.cuh, three
// TF32 products for each f32 one: 12*B*N*N*E flops over the dense TF32
// peak of 495 TFLOP/s, 0.31 ms at (1, 10000, 128) and 2.72 ms at
// (8, 10000, 140) (3.10 at the 160 it runs at). The f32 CUDA cores' 67
// TFLOP/s would allow no less than 0.76 and 6.7 ms.
//
// The products of a tile, for a warp's 16 rows:
//   * S = Q.X^T (16 x 32) by mma.sync m16n8k8, A from the query rows and B
//     from the x tile, both K-major (rows contiguous along E);
//   * P = exp(max((S - 1) * inv_b2, -75)), zero at columns >= n, stays in
//     the registers of S's C fragments, and den sums it;
//   * num += P.X (16 x E) by mma.sync as well: P's C fragments serve as the
//     A fragments of the next product once the contraction index is
//     permuted (k = t <-> column 2t, k = t + 4 <-> column 2t + 1), and the
//     B fragments come with the same permutation from the row-major tile
//     (X[2t][8 et + g], X[2t + 1][8 et + g]), again on 32 banks.
// Why mma.sync and not wgmma: a TF32 wgmma takes both operands K-major from
// shared memory (A may come from registers, but B may not). P.X contracts
// over the column index, so its B would be X^T, a transposed copy of every
// tile in a swizzled layout; mma.sync loads both products' fragments from
// the one row-major tile, and P never touches shared memory.
// Each tile's P.X is summed in two fresh fragments, the small terms and
// hi.hi, and added to num on the CUDA cores, so no tensor-core accumulator
// takes more than 8 TF32 products (they truncate). The tiles are float32
// at a stride of E + 4 words. Shared memory at E = 160: 84 KB (the query
// rows 42 KB, the two x stages 42 KB together), two blocks an SM; the
// HPNet-enriched embedding is 140-d and runs at 160.
#include <cuda_runtime.h>

#include "mean_shift.cuh"

namespace {

using namespace sim_tile;

struct F32Tile {
  using T = float;

  template <int E>
  __host__ __device__ static constexpr int pitch() { return stride<E>(); }

  template <int E>
  __device__ __forceinline__ static void load(float* dst, const float* src,
                                              int r0, int rows, int n) {
    load_rows<E>(dst, src, r0, rows, n);
  }

  template <int E>
  __device__ __forceinline__ static void products(
      const float* qw, const float* xt, int g, int t, int c0, int n,
      float ib2, float (&num)[E / 8][4], float (&den)[2]) {
    constexpr int S = stride<E>();
    float sim[NT][4];
    similarity<E>(qw, xt, g, t, sim);

    // kernel weights, split into the A fragments of P.X: C slot v (row
    // g + 8 (v >> 1), column 2t + (v & 1)) goes to A slot
    // 2 (v & 1) + (v >> 1)
    uint32_t phi[NT][4], plo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = c0 + 8 * j + 2 * t + (v & 1);
        const float w =
            c < n ? expf(fmaxf((sim[j][v] - 1.f) * ib2, -75.f)) : 0.f;
        den[v >> 1] += w;
        const int a = 2 * (v & 1) + (v >> 1);
        split(w, phi[j][a], plo[j][a]);
      }

#pragma unroll
    for (int et = 0; et < E / 8; ++et) {
      float small[4] = {0.f, 0.f, 0.f, 0.f}, big[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = xt + (8 * j + 2 * t) * S + 8 * et + g;
        uint32_t bhi[2], blo[2];
        split(p[0], bhi[0], blo[0]);
        split(p[S], bhi[1], blo[1]);
        mma(small, plo[j], bhi);
        mma(small, phi[j], blo);
        mma(big, phi[j], bhi);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) num[et][v] += small[v] + big[v];
    }
  }
};

}  // namespace

// q, out: (B, M, E), x: (B, N, E), float32 contiguous, E a multiple of 32
// up to 256 (M = N for a whole shape's step, M < N for a row shard of the
// sharded shift); inv_b2: (B,) float32.
extern "C" int sednet_mean_shift_step(const void* q, const void* x,
                                      const void* inv_b2, int batch, int m,
                                      int n, int e, void* out, void* stream) {
  return mean_shift::launch_width<F32Tile>(q, x, inv_b2, batch, m, n, e, out,
                                           stream);
}
