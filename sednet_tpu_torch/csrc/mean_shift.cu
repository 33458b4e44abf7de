// One gaussian mean-shift step on the unit sphere, for a batch of shapes.
//
// Replaces the TPU kernels `_ms_kernel` (mean_shift_step_pallas) and
// `_ms_kernel_batched` (mean_shift_step_pallas_batched) of
// sednet_tpu/ops/pallas_kernels.py. For every shape b and query row i:
//
//   k[i, c]  = exp(max((q_i . x_c - 1) * inv_b2[b], -75))     (c < n)
//   out[i]   = rownorm(sum_c k[i, c] x_c / max(sum_c k[i, c], 1e-30))
//
// with the row norm taken as sqrt(max(|v|^2, 1e-24)).
//
// Bound on the H100: operations. A call does two products of N x N x E
// per shape, 4*B*N*N*E flops, against 3*B*N*E floats of traffic. Both run
// on the tensor cores by the three-term TF32 split of sim_tile.cuh, three
// TF32 products for each f32 one: 12*B*N*N*E flops over the dense TF32
// peak of 495 TFLOP/s, 0.31 ms at (1, 10000, 128) and 2.72 ms at
// (8, 10000, 140) (3.10 at the 160 it runs at). The f32 CUDA cores' 67
// TFLOP/s would allow no less than 0.76 and 6.7 ms.
//
// Design, flash-attention-like: the N x N matrix never leaves registers.
// A cluster of SPLIT = 4 blocks owns 64 query rows of one shape; each block
// holds the rows in shared memory and walks a quarter of the 32-column
// tiles of x (tiles part, part + 4, ...), loaded by cp.async into two
// stages, the next tile landing while this one is used. Each of 4 warps
// owns 16 rows:
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
// takes more than 8 TF32 products (they truncate). The four blocks of a
// cluster then add their (num, den) partials in rank order through
// distributed shared memory, each finishing 16 of the 64 rows: normalise,
// row norm, store. Splitting the columns gives 628 blocks to the 132 SMs
// for a single 10000-point shape (157 clusters), where one block per 64
// rows gave 157. Shared memory at E = 160: 84 KB (the query rows 42 KB,
// the two x stages 42 KB together), two blocks an SM. The kernel is a
// template on the row width E, a multiple of 32 up to 256 (the wrapper
// zero-pads: the HPNet-enriched embedding is 140-d and runs at 160). q, x
// and out must be 16-byte aligned, as every contiguous tensor from torch's
// allocator is.
#include <cuda_runtime.h>

#include "sim_tile.cuh"

namespace {

using namespace sim_tile;

template <int E>
constexpr int smem_bytes() {
  return ((RB + STAGES * CB) * stride<E>() + RB) * 4;
}

template <int E>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS)
ms_step_kernel(const float* __restrict__ q, const float* __restrict__ x,
               const float* __restrict__ inv_b2, int n,
               float* __restrict__ out) {
  constexpr int S = stride<E>();
  constexpr int ET = E / 8;       // 8-column n-tiles of an output row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // RB x S: query rows, then num
  float* xs = qs + RB * S;               // STAGES x CB x S
  float* dens = xs + STAGES * CB * S;    // RB partial den

  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / SPLIT) * RB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)b * n * E;
  const float* xb = x + base;
  const float ib2 = inv_b2[b];
  const int tiles = (n + CB - 1) / CB;
  const int mine = tiles > part ? (tiles - part + SPLIT - 1) / SPLIT : 0;

  load_rows<E>(qs, q + base, r0, RB, n);
  cp_async_commit();
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine)
      load_rows<E>(xs + s * CB * S, xb, (part + s * SPLIT) * CB, CB, n);
    cp_async_commit();
  }

  // C fragments: num[et] holds rows g, g + 8 at columns 8 et + 2t, + 1
  float num[ET][4];
#pragma unroll
  for (int et = 0; et < ET; ++et)
#pragma unroll
    for (int v = 0; v < 4; ++v) num[et][v] = 0.f;
  float den[2] = {0.f, 0.f};
  const float* qw = qs + warp * 16 * S;

#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile k is in; tile k - 1's stage is free
    const int nk = k + STAGES - 1;
    if (nk < mine)
      load_rows<E>(xs + (nk % STAGES) * CB * S, xb,
                   (part + nk * SPLIT) * CB, CB, n);
    cp_async_commit();

    const float* xt = xs + (k % STAGES) * CB * S;
    const int c0 = (part + k * SPLIT) * CB;
    float sim[NT][4];
    similarity<E>(qw, xt, g, t, sim);

    // kernel weights, split into the A fragments of P.X: C slot v (row
    // g + 8 (v >> 1), column 2t + (v & 1)) goes to A slot 2 (v & 1) + (v >> 1)
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
    for (int et = 0; et < ET; ++et) {
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
  cp_async_wait<0>();
  __syncthreads();   // every copy into this block's shared memory has landed

  // den of rows g and g + 8: the 4 threads of a group hold its columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
  // each warp overwrites only its own 16 query rows with its partial num
  float* pn = qs + warp * 16 * S;
#pragma unroll
  for (int et = 0; et < ET; ++et) {
    pn[g * S + 8 * et + 2 * t] = num[et][0];
    pn[g * S + 8 * et + 2 * t + 1] = num[et][1];
    pn[(g + 8) * S + 8 * et + 2 * t] = num[et][2];
    pn[(g + 8) * S + 8 * et + 2 * t + 1] = num[et][3];
  }
  if (t == 0) {
    dens[warp * 16 + g] = den[0];
    dens[warp * 16 + g + 8] = den[1];
  }
  cluster.sync();

  // this block finishes rows part * ROWS_OUT ... of the 64, 8 threads a row
  constexpr int V4 = E / 32;       // float4s per thread
  const int lr = part * ROWS_OUT + threadIdx.x / 8;
  const int j8 = threadIdx.x % 8;
  float4 acc[V4];
#pragma unroll
  for (int i = 0; i < V4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float d = 0.f;
#pragma unroll
  for (int p = 0; p < SPLIT; ++p) {   // fixed order: the same sums each run
    const float* rq = cluster.map_shared_rank(qs, p);
    d += cluster.map_shared_rank(dens, p)[lr];
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(rq + lr * S + 4 * (j8 + 8 * i));
      acc[i].x += a.x;
      acc[i].y += a.y;
      acc[i].z += a.z;
      acc[i].w += a.w;
    }
  }
  d = fmaxf(d, 1e-30f);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V4; ++i) {
    acc[i].x /= d;
    acc[i].y /= d;
    acc[i].z /= d;
    acc[i].w /= d;
    ss = fmaf(acc[i].x, acc[i].x, ss);
    ss = fmaf(acc[i].y, acc[i].y, ss);
    ss = fmaf(acc[i].z, acc[i].z, ss);
    ss = fmaf(acc[i].w, acc[i].w, ss);
  }
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float nrm = sqrtf(fmaxf(ss, 1e-24f));
  const int gr = r0 + lr;
  if (gr < n) {
    float* o = out + base + (size_t)gr * E;
#pragma unroll
    for (int i = 0; i < V4; ++i)
      *reinterpret_cast<float4*>(o + 4 * (j8 + 8 * i)) = make_float4(
          acc[i].x / nrm, acc[i].y / nrm, acc[i].z / nrm, acc[i].w / nrm);
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <int E>
int launch(const float* q, const float* x, const float* inv_b2, int batch,
           int n, float* out, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(x) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      ms_step_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<E>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((n + RB - 1) / RB) * SPLIT, batch);
  ms_step_kernel<E><<<grid, THREADS, smem_bytes<E>(), stream>>>(
      q, x, inv_b2, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// q, x, out: (B, N, E) float32 contiguous, E a multiple of 32 up to 256;
// inv_b2: (B,) float32.
extern "C" int sednet_mean_shift_step(const void* q, const void* x,
                                      const void* inv_b2, int batch, int n,
                                      int e, void* out, void* stream) {
  const float* qf = (const float*)q;
  const float* xf = (const float*)x;
  const float* bf = (const float*)inv_b2;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (e) {
    case 32: return launch<32>(qf, xf, bf, batch, n, of, st);
    case 64: return launch<64>(qf, xf, bf, batch, n, of, st);
    case 96: return launch<96>(qf, xf, bf, batch, n, of, st);
    case 128: return launch<128>(qf, xf, bf, batch, n, of, st);
    case 160: return launch<160>(qf, xf, bf, batch, n, of, st);
    case 192: return launch<192>(qf, xf, bf, batch, n, of, st);
    case 224: return launch<224>(qf, xf, bf, batch, n, of, st);
    case 256: return launch<256>(qf, xf, bf, batch, n, of, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
