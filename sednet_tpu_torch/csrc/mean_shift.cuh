// The float32 mean-shift step's kernel (K2/K2b, mean_shift.cu, the
// three-term TF32 split) around its tile products: the walk over x's
// tiles, the cluster's reduction of (num, den) and the normalisation. It
// serves that one form; the bf16 step (mean_shift_bf16.cu) has a kernel of
// its own on wgmma and TMA. For every shape b and query row i:
//
//   k[i, c]  = exp(max((q_i . x_c - 1) * inv_b2[b], -75))     (c < n)
//   out[i]   = rownorm(sum_c k[i, c] x_c / max(sum_c k[i, c], 1e-30))
//
// with the row norm taken as sqrt(max(|v|^2, 1e-24)); the form says how it
// rounds the two products.
//
// Layout, flash-attention-like: the N x N matrix never leaves registers.
// A cluster of SPLIT = 4 blocks owns 64 query rows of one shape; each block
// holds the rows in shared memory and walks a quarter of the 32-column
// tiles of x (tiles part, part + 4, ...), loaded by cp.async into two
// stages, the next tile landing while this one is used. Each of 4 warps
// owns 16 rows and adds each tile's products into its num (C fragments of
// 16 x E) and den (rows g and g + 8). After the walk the tiles' shared
// memory holds each warp's float32 partial num at a stride of E + 4, and
// the four blocks of a cluster add their (num, den) partials in rank order
// through distributed shared memory, each finishing 16 of the 64 rows:
// normalise, row norm, store. Splitting the columns gives 628 blocks to the
// 132 SMs for a single 10000-point shape (157 clusters), where one block
// per 64 rows gave 157.
//
// The form is a Tile type with
//   T                       the element type of the tiles in shared memory;
//   pitch<E>()              their row stride in elements (32 banks a
//                           fragment load);
//   load<E>(dst, src, r0, rows, n)
//                           rows [r0, r0 + rows) of a (n, E) array of T
//                           into shared memory by cp.async, rows at or past
//                           n as zeros (the caller commits the group);
//   products<E>(qw, xt, g, t, c0, n, ib2, num, den)
//                           one tile's S = Q.X^T for the warp's 16 rows at
//                           qw against the 32 rows at xt (columns c0 ...),
//                           its weights (zero at columns >= n) added to den
//                           and its P.X to num.
// The kernel is a template on the row width E, a multiple of 32 up to 256
// (the wrappers zero-pad). q, x and out must be 16-byte aligned, as every
// contiguous tensor from torch's allocator is.
#pragma once

#include <cuda_runtime.h>

#include "sim_tile.cuh"

namespace mean_shift {

using namespace sim_tile;

template <class Tile, int E>
__host__ __device__ constexpr int tiles_bytes() {
  return (RB + STAGES * CB) * Tile::template pitch<E>() *
         (int)sizeof(typename Tile::T);
}

// the float32 partial num of the 64 rows, over the tiles after the walk
template <int E>
__host__ __device__ constexpr int num_bytes() { return RB * stride<E>() * 4; }

// the partial den of the 64 rows follows the larger of the two
template <class Tile, int E>
__host__ __device__ constexpr int dens_offset() {
  return tiles_bytes<Tile, E>() > num_bytes<E>() ? tiles_bytes<Tile, E>()
                                                  : num_bytes<E>();
}

template <class Tile, int E>
constexpr int smem_bytes() { return dens_offset<Tile, E>() + RB * 4; }

template <class Tile, int E>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS)
step_kernel(const typename Tile::T* __restrict__ q,
            const typename Tile::T* __restrict__ x,
            const float* __restrict__ inv_b2, int m, int n,
            float* __restrict__ out) {
  using T = typename Tile::T;
  constexpr int P = Tile::template pitch<E>();
  constexpr int S = stride<E>();
  constexpr int ET = E / 8;       // 8-column n-tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);              // RB x P query rows
  T* xs = qs + RB * P;                                 // STAGES x CB x P
  float* nums = reinterpret_cast<float*>(smem_raw);    // RB x S, after walk
  float* dens = reinterpret_cast<float*>(smem_raw + dens_offset<Tile, E>());

  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / SPLIT) * RB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qbase = (size_t)b * m * E;   // query and output rows
  const T* xb = x + (size_t)b * n * E;
  const float ib2 = inv_b2[b];
  const int tiles = (n + CB - 1) / CB;
  const int mine = tiles > part ? (tiles - part + SPLIT - 1) / SPLIT : 0;

  Tile::template load<E>(qs, q + qbase, r0, RB, m);
  cp_async_commit();
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine)
      Tile::template load<E>(xs + s * CB * P, xb, (part + s * SPLIT) * CB,
                             CB, n);
    cp_async_commit();
  }

  // C fragments: num[et] holds rows g, g + 8 at columns 8 et + 2t, + 1
  float num[ET][4];
#pragma unroll
  for (int et = 0; et < ET; ++et)
#pragma unroll
    for (int v = 0; v < 4; ++v) num[et][v] = 0.f;
  float den[2] = {0.f, 0.f};
  const T* qw = qs + warp * 16 * P;

#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile k is in; tile k - 1's stage is free
    const int nk = k + STAGES - 1;
    if (nk < mine)
      Tile::template load<E>(xs + (nk % STAGES) * CB * P, xb,
                             (part + nk * SPLIT) * CB, CB, n);
    cp_async_commit();
    Tile::template products<E>(qw, xs + (k % STAGES) * CB * P, g, t,
                               (part + k * SPLIT) * CB, n, ib2, num, den);
  }
  cp_async_wait<0>();
  __syncthreads();   // every copy has landed and every warp left the tiles

  // den of rows g and g + 8: the 4 threads of a group hold its columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
  float* pn = nums + warp * 16 * S;
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
    const float* rq = cluster.map_shared_rank(nums, p);
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
  if (gr < m) {
    float* o = out + qbase + (size_t)gr * E;
#pragma unroll
    for (int i = 0; i < V4; ++i)
      *reinterpret_cast<float4*>(o + 4 * (j8 + 8 * i)) = make_float4(
          acc[i].x / nrm, acc[i].y / nrm, acc[i].z / nrm, acc[i].w / nrm);
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <class Tile, int E>
int launch(const void* q, const void* x, const float* inv_b2, int batch,
           int m, int n, float* out, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(x) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel<Tile, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<Tile, E>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((m + RB - 1) / RB) * SPLIT, batch);
  step_kernel<Tile, E><<<grid, THREADS, smem_bytes<Tile, E>(), stream>>>(
      (const typename Tile::T*)q, (const typename Tile::T*)x, inv_b2, m, n,
      out);
  return (int)cudaGetLastError();
}

// q: (B, M, E), x: (B, N, E) contiguous arrays of Tile::T, E a multiple of
// 32 up to 256; inv_b2: (B,) float32; out: (B, M, E) float32 contiguous.
template <class Tile>
int launch_width(const void* q, const void* x, const void* inv_b2, int batch,
                 int m, int n, int e, void* out, void* stream) {
  const float* bf = (const float*)inv_b2;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (e) {
    case 32: return launch<Tile, 32>(q, x, bf, batch, m, n, of, st);
    case 64: return launch<Tile, 64>(q, x, bf, batch, m, n, of, st);
    case 96: return launch<Tile, 96>(q, x, bf, batch, m, n, of, st);
    case 128: return launch<Tile, 128>(q, x, bf, batch, m, n, of, st);
    case 160: return launch<Tile, 160>(q, x, bf, batch, m, n, of, st);
    case 192: return launch<Tile, 192>(q, x, bf, batch, m, n, of, st);
    case 224: return launch<Tile, 224>(q, x, bf, batch, m, n, of, st);
    case 256: return launch<Tile, 256>(q, x, bf, batch, m, n, of, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mean_shift
