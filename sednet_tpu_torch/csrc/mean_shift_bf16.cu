// One gaussian mean-shift step on the unit sphere with bf16 tile inputs,
// for a batch of shapes: the `bf16=True` branch of the TPU kernels
// `_ms_kernel` (mean_shift_step_pallas) and `_ms_kernel_batched`
// (mean_shift_step_pallas_batched) of sednet_tpu/ops/pallas_kernels.py
// (config.ms_bf16). The wrapper rounds new_x and x to bf16 (round to
// nearest even, as JAX's astype does); then, for every shape b and query
// row i:
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
// (989 TFLOP/s dense), 0.41 ms at (8, 10000, 128); beside them B*N*N exps,
// which the SFUs issue at 16 a cycle an SM (0.19 ms at (8, 10000) on 132
// SMs at 1.98 GHz), and 3*B*N*E*4 bytes.
//
// Design, after FlashAttention-3's forward (no running max: the weights
// are exps of a clamped argument, never rescaled):
//   * TMA. One 3-D tensor map over each (B, N, E) bf16 array, boxes of 64
//     columns (128 bytes, the span of the 128-byte swizzle) by 64 rows, so
//     no tile crosses a shape; rows past N and columns past E read zeros.
//     A tile of CB = 64 rows is ceil(E / 64) column chunks of 64 x 64,
//     each swizzled as wgmma's canonical 128-byte layout wants it.
//   * A block owns 128 query rows of one shape: two consumer warpgroups of
//     64 rows each and one producer warp (of a third warpgroup, which gives
//     its registers to the consumers by setmaxnreg). The producer loads the
//     query rows once and keeps a ring of STAGES x tiles in flight on
//     full / empty mbarriers.
//   * Both products on wgmma (wgmma.mma_async, the wrappers of wgmma.cuh)
//     from the one copy of each tile:
//     S = Q.X^T (m64n64k16, A = the query rows and B = the tile, both
//     K-major); P = exp2(max((S - 1) * inv_b2 * log2(e), -75 log2(e))) in
//     the registers of S (one ex2.approx.ftz a weight), den sums it, and it
//     is rounded to bf16 in place into P.X's register A operand (the f32
//     accumulator layout of S is the A-fragment layout of a 16-bit operand);
//     num += P.X (m64nEk16; E % 64 columns in a second, narrower product)
//     takes B as the same tile read MN-major (wgmma's transpose bit).
//   * The two consumer warpgroups take turns on named barriers (ping-pong):
//     one issues S of tile k and P.X of tile k - 1 back to back, then lets
//     the other issue, and takes its exps while the tensor cores run the
//     other's products.
//   * A column split for small grids: a cluster of `split` blocks (1 to 8,
//     chosen at each launch from the grid and the SM count) shares one row
//     block, each walking the tiles part, part + split, ...; the blocks add
//     their float32 (num, den) partials in rank order through distributed
//     shared memory. Every sum runs in a fixed order: the same bits on
//     every launch.
// Accumulation. S is two partials, each over half the k-steps in a fresh
// accumulator, added in float32; num chains over the whole walk. The form
// was chosen by how it rounds a few weights, not by a bound: the largest
// float64 error is decided by single weights that lie within 1e-3 of a
// bf16 step of a rounding midpoint (s 2e-10 to 9e-8 from it), and every
// float32 sum of s, the plain version's too, errs by 1e-8 to 3e-7 and
// rounds such a weight by the sign of its last bits. On an H100
// (scripts/probe_ms_bf16_accum.py, the smoke's inputs): S chained over all
// E / 16 k-steps errs low (1.5e-7 to 2.6e-7 at those weights) and fails
// the smoke's rule at 3.7x the plain version's error on the enriched
// embeddings; two partials pass at 0.76x, four (lower mean error) fail at
// 3.7x on the same weight, and over 16 draws with scaled bandwidths two
// partials fail one at 2.02x. Summing each k-step alone in float32 passed
// every draw, at twice the time.
// Registers a thread: num E / 2, S's partials 2 x 32, P 16.
// Widths: multiples of 16 up to 256 (the wrappers zero-pad; the 140-d
// enriched embedding runs at 144).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int ROWS = 128;          // query rows a block, 64 a warpgroup
constexpr int BOX = 64;            // columns of a TMA box: 128 bf16 bytes
constexpr int BOX_ROWS = 64;       // rows of a TMA box
constexpr int THREADS = 384;       // the producer's warpgroup, 2 consumers
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int BAR_BYTES = 256;     // the mbarriers, after the tiles
constexpr int MAX_SPLIT = 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// named barriers (0 is __syncthreads): the consumers' turns, their end
constexpr int BAR_TURN = 1, BAR_DONE = 3;
constexpr float LOG2E = 1.4426950408889634f;
// a failed tensor-map encode returns this plus its CUresult (errors.cu)
constexpr int SEDNET_ENCODE_ERROR = 20000;

template <int E>
struct Geo {
  static constexpr int CB = 64;                       // columns a tile
  static constexpr int CHUNKS = (E + BOX - 1) / BOX;  // 64-column chunks
  static constexpr int Q_BYTES = CHUNKS * ROWS * 128;
  static constexpr int X_BYTES = CHUNKS * CB * 128;   // one stage
  static constexpr int STAGES = 4;                   // tiles in flight
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * X_BYTES + BAR_BYTES;
  static constexpr int NMAIN = E / 64 * 64;   // P.X's columns in one product
  static constexpr int NTAIL = E % 64;        // and in a second one
  static constexpr int PITCH = E + 8;         // floats, the partial num
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  static_assert(ROWS * (PITCH + 1) * 4 <= Q_BYTES + STAGES * X_BYTES,
                "the partials fit over the tiles");
  static_assert(2 * STAGES + 1 <= BAR_BYTES / 8, "mbarriers");
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int shape) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(shape) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// A wgmma descriptor of the 128-byte-swizzled layout at shared address a:
// lbo and sbo in bytes (K-major: sbo the 8-row stride, lbo unused;
// MN-major: lbo the stride of the 64-column chunks, sbo the 8-row stride).
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
struct Acc {   // an accumulator of N columns (N may be 0)
  float r[N / 2 > 0 ? N / 2 : 1];
};

template <int E>
struct Consumer {
  using G = Geo<E>;
  static constexpr int CB = G::CB;
  static constexpr int KS = E / 16;          // S's k-steps
  static constexpr int HALF = (KS + 1) / 2;  // those in S's first partial
  Acc<G::NMAIN> nm;
  Acc<G::NTAIL> nt;
  float s[CB / 2];    // S (its first partial), then the tile's weights
  float s2[CB / 2];   // S's second partial
  uint32_t p[CB / 16][4];
  float den[2];

  // S = Q.X^T for the warpgroup's 64 rows (descriptor q) against the tile
  // (descriptor x), both K-major: k-step kk is 32 bytes into chunk kk / 4.
  // The k-steps go to two fresh accumulators, [0, HALF) and [HALF, KS),
  // summed in float32 once they are done (`sum_s`).
  __device__ __forceinline__ void issue_s(uint64_t q, uint64_t x) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t qo = ((kk / 4) * ROWS * 128 + (kk % 4) * 32) >> 4;
      const uint32_t xo = ((kk / 4) * CB * 128 + (kk % 4) * 32) >> 4;
      if (kk < HALF)
        wgmma::SS<CB>::mma(s, q + qo, x + xo, kk > 0);
      else
        wgmma::SS<CB>::mma(s2, q + qo, x + xo, kk > HALF);
    }
  }

  __device__ __forceinline__ void fence_s() {
    wgmma::fence_operands(s);
    wgmma::fence_operands(s2);
  }

  __device__ __forceinline__ void sum_s() {
    if constexpr (HALF < KS) {
#pragma unroll
      for (int v = 0; v < CB / 2; ++v) s[v] += s2[v];
    }
  }

  // num += P.X, P from registers, the tile (descriptor x) MN-major: k-step
  // ks is the tile's rows 16 ks ..., 2048 bytes on
  __device__ __forceinline__ void px(uint64_t x) {
#pragma unroll
    for (int ks = 0; ks < CB / 16; ++ks) {
      const uint32_t o = (ks * 16 * 128) >> 4;
      if constexpr (G::NMAIN > 0)
        wgmma::RS<G::NMAIN>::mma(nm.r, p[ks], x + o, 1);
      if constexpr (G::NTAIL > 0)
        wgmma::RS<G::NTAIL>::mma(
            nt.r, p[ks], x + o + ((G::NMAIN / 64) * CB * 128 >> 4), 1);
    }
  }

  __device__ __forceinline__ void fence_num() {
    if constexpr (G::NMAIN > 0) wgmma::fence_operands(nm.r);
    if constexpr (G::NTAIL > 0) wgmma::fence_operands(nt.r);
  }

  // the weights of tile columns c0 ... in place of S, summed into den
  __device__ __forceinline__ void weights(int c0, int n, float c2, int t) {
    constexpr float LO = -75.f * LOG2E;
    const bool ragged = c0 + CB > n;
#pragma unroll
    for (int v = 0; v < CB / 2; ++v) {
      float k = ex2(fmaxf((s[v] - 1.f) * c2, LO));
      if (ragged && c0 + 8 * (v / 4) + 2 * t + (v & 1) >= n) k = 0.f;
      den[(v >> 1) & 1] += k;
      s[v] = k;
    }
  }

  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int ks = 0; ks < CB / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[ks][i] = pack_bf16(s[8 * ks + 2 * i], s[8 * ks + 2 * i + 1]);
  }
};

template <int E>
__global__ void __launch_bounds__(THREADS, 1)
step_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tx,
            const float* __restrict__ inv_b2, int n,
            float* __restrict__ out) {
  using G = Geo<E>;
  constexpr int CB = G::CB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on such a line
  unsigned char* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const uint32_t qs = saddr(base);
  const uint32_t xs = qs + G::Q_BYTES;
  const uint32_t bars = xs + G::STAGES * G::X_BYTES;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (STAGES + s), q: the last
  const uint32_t qbar = bars + 16 * G::STAGES;
  float* nums = reinterpret_cast<float*>(base);    // ROWS x PITCH, after
  float* dens = nums + ROWS * G::PITCH;            // ROWS

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / split) * ROWS;
  const int tiles = (n + CB - 1) / CB;
  const int mine = tiles > part ? (tiles - part + split - 1) / split : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (G::STAGES + s), 8);   // a consumer warp each
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0 && mine > 0) {
      mbar_expect_tx(qbar, G::Q_BYTES);
      for (int c = 0; c < G::CHUNKS; ++c)
        for (int h = 0; h < ROWS / BOX_ROWS; ++h)
          tma_load(qs + c * ROWS * 128 + h * BOX_ROWS * 128, &tq, qbar,
                   c * BOX, r0 + h * BOX_ROWS, b);
      for (int k = 0; k < mine; ++k) {
        const int st = k % G::STAGES;
        mbar_wait(bars + 8 * (G::STAGES + st), ((k / G::STAGES) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * st, G::X_BYTES);
        const int row = (part + k * split) * CB;
        const uint32_t dst = xs + st * G::X_BYTES;
        for (int c = 0; c < G::CHUNKS; ++c)
          for (int h = 0; h < CB / BOX_ROWS; ++h)
            tma_load(dst + c * CB * 128 + h * BOX_ROWS * 128, &tx,
                     bars + 8 * st, c * BOX, row + h * BOX_ROWS, b);
      }
    }
    __syncwarp();
    cluster_sync();   // the partials are written
    cluster_sync();   // and read
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
  const int cw = threadIdx.x / 128 - 1;         // consumer 0 or 1
  const int ct = threadIdx.x - 128;             // 0 ... 255
  const int warp = (threadIdx.x / 32) & 3;      // warp of the warpgroup
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float c2 = inv_b2[b] * LOG2E;
  const int me = BAR_TURN + cw, other = BAR_TURN + 1 - cw;

  Consumer<E> w;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(w.nm.r) / 4); ++i) w.nm.r[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(w.nt.r) / 4); ++i) w.nt.r[i] = 0.f;
  w.den[0] = w.den[1] = 0.f;

  // K-major: rows of 128 bytes, 8-row groups 1024 apart; MN-major (P.X's
  // B): 64-column chunks CB * 128 bytes apart, 8-row groups 1024 apart
  const uint64_t qd = desc(qs + cw * 64 * 128, 16, 1024);
  const uint64_t xk = desc(xs, 16, 1024), xm = desc(xs, CB * 128, 1024);
  const uint32_t stage_off = G::X_BYTES >> 4;

  if (mine > 0) {
    if (cw == 1) named_arrive(BAR_TURN);   // consumer 0 takes the first turn
    mbar_wait(qbar, 0);
    mbar_wait(bars, 0);
    named_sync(me);
    w.fence_s();
    wgmma::fence();
    w.issue_s(qd, xk);
    wgmma::commit();
    named_arrive(other);
    wgmma::wait<0>();
    w.fence_s();
    w.sum_s();
    w.weights(part * CB, n, c2, t);
    w.pack();
#pragma unroll 1
    for (int k = 1; k < mine; ++k) {
      const int st = k % G::STAGES, pst = (k - 1) % G::STAGES;
      mbar_wait(bars + 8 * st, (k / G::STAGES) & 1);
      named_sync(me);
      w.fence_s();
      w.fence_num();
      wgmma::fence();
      w.issue_s(qd, xk + st * stage_off);
      wgmma::commit();
      w.px(xm + pst * stage_off);
      wgmma::commit();
      named_arrive(other);
      wgmma::wait<1>();
      w.fence_s();
      w.sum_s();
      w.weights((part + k * split) * CB, n, c2, t);
      wgmma::wait<0>();
      w.fence_num();
      if (lane == 0) mbar_arrive(bars + 8 * (G::STAGES + pst));
      w.pack();
    }
    named_sync(me);
    w.fence_num();
    wgmma::fence();
    w.px(xm + ((mine - 1) % G::STAGES) * stage_off);
    wgmma::commit();
    if (cw == 0) named_arrive(other);   // consumer 1 ends the turns
    wgmma::wait<0>();
    w.fence_num();
  }

  // den of rows g and g + 8: the 4 threads of a group hold its columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w.den[h] += __shfl_xor_sync(0xffffffffu, w.den[h], 1);
    w.den[h] += __shfl_xor_sync(0xffffffffu, w.den[h], 2);
  }
  named_sync(BAR_DONE);   // both consumers have left the tiles
  const int row = cw * 64 + warp * 16 + g;
#pragma unroll
  for (int v = 0; v < G::NMAIN / 2; v += 2) {
    const int r = row + 8 * ((v >> 1) & 1), c = 8 * (v / 4) + 2 * t;
    *reinterpret_cast<float2*>(nums + r * G::PITCH + c) =
        make_float2(w.nm.r[v], w.nm.r[v + 1]);
  }
#pragma unroll
  for (int v = 0; v < G::NTAIL / 2; v += 2) {
    const int r = row + 8 * ((v >> 1) & 1);
    const int c = G::NMAIN + 8 * (v / 4) + 2 * t;
    *reinterpret_cast<float2*>(nums + r * G::PITCH + c) =
        make_float2(w.nt.r[v], w.nt.r[v + 1]);
  }
  if (t == 0) {
    dens[row] = w.den[0];
    dens[row + 8] = w.den[1];
  }
  cluster_sync();

  // this block finishes rows part * rows_out ... of the 128, 8 threads a
  // row, 32 rows at a time
  constexpr int V4 = (E / 4 + 7) / 8;   // float4s a thread
  const int rows_out = ROWS / split;
  const int j8 = ct % 8;
  for (int lr = part * rows_out + ct / 8; lr < (part + 1) * rows_out;
       lr += 32) {
    float4 acc[V4];
#pragma unroll
    for (int i = 0; i < V4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float d = 0.f;
    for (int p = 0; p < split; ++p) {   // fixed order: the same sums each run
      const float* rq = cluster.map_shared_rank(nums, p);
      d += cluster.map_shared_rank(dens, p)[lr];
#pragma unroll
      for (int i = 0; i < V4; ++i) {
        if (4 * (j8 + 8 * i) < E) {
          const float4 a = *reinterpret_cast<const float4*>(
              rq + lr * G::PITCH + 4 * (j8 + 8 * i));
          acc[i].x += a.x;
          acc[i].y += a.y;
          acc[i].z += a.z;
          acc[i].w += a.w;
        }
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
      float* o = out + ((size_t)b * n + gr) * E;
#pragma unroll
      for (int i = 0; i < V4; ++i)
        if (4 * (j8 + 8 * i) < E)
          *reinterpret_cast<float4*>(o + 4 * (j8 + 8 * i)) =
              make_float4(acc[i].x / nrm, acc[i].y / nrm, acc[i].z / nrm,
                          acc[i].w / nrm);
    }
  }
  cluster_sync();   // no block leaves while another reads its partials
}

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (the
// library links no libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeFn* fn) {
  static std::once_flag once;
  static EncodeFn found = nullptr;
  static cudaError_t err = cudaSuccess;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                           12000, cudaEnableDefault, &q);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                  cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && (q != cudaDriverEntryPointSuccess || !p))
      err = cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeFn>(p);
  });
  *fn = found;
  return err;
}

// the map of a (batch, n, e) bf16 array: boxes of 64 columns by 64 rows of
// one shape, 128-byte swizzle, zeros outside
int encode(CUtensorMap* map, const void* p, int batch, int n, int e) {
  EncodeFn fn;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims[3] = {(cuuint64_t)e, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)e * 2, (cuuint64_t)n * e * 2};
  const cuuint32_t box[3] = {BOX, BOX_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : SEDNET_ENCODE_ERROR + (int)r;
}

// the column split: the cluster size (a power of 2 up to MAX_SPLIT and
// the tile count) with the least time in waves of one block an SM, a
// block's walk costing 1 / split of the whole plus a fixed 0.05
int choose_split(int blocks, int tiles, int sms) {
  int best = 1;
  float best_cost = 1e30f;
  for (int s = 1; s <= MAX_SPLIT && s <= tiles; s *= 2) {
    const int waves = (blocks * s + sms - 1) / sms;
    const float cost = waves * (1.f / s + 0.05f);
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

int sm_count(int* sms) {
  static std::mutex mu;
  static int known[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!known[dev]) {
    err = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = known[dev];
  return 0;
}

template <int E>
int launch(const void* q, const void* x, const float* inv_b2, int batch,
           int n, float* out, cudaStream_t stream) {
  using G = Geo<E>;
  if (((uintptr_t)q & 15) || ((uintptr_t)x & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorMisalignedAddress;
  if (n <= 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tx;
  int rc = encode(&tq, q, batch, n, E);
  if (rc) return rc;
  if ((rc = encode(&tx, x, batch, n, E))) return rc;
  int sms = 0;
  if ((rc = sm_count(&sms))) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (n + ROWS - 1) / ROWS;
  const int split = choose_split(row_blocks * batch, (n + G::CB - 1) / G::CB,
                                 sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks * split, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, step_kernel<E>, tq, tx, inv_b2, n, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q, x: (B, N, E) bf16 contiguous, E a multiple of 16 up to 256; inv_b2:
// (B,) float32; out: (B, N, E) float32 contiguous. A failed tensor-map
// encode returns SEDNET_ENCODE_ERROR + its CUresult.
extern "C" int sednet_mean_shift_step_bf16(const void* q, const void* x,
                                           const void* inv_b2, int batch,
                                           int n, int e, void* out,
                                           void* stream) {
  const float* bf = (const float*)inv_b2;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (e) {
    case 16: return launch<16>(q, x, bf, batch, n, of, st);
    case 32: return launch<32>(q, x, bf, batch, n, of, st);
    case 48: return launch<48>(q, x, bf, batch, n, of, st);
    case 64: return launch<64>(q, x, bf, batch, n, of, st);
    case 80: return launch<80>(q, x, bf, batch, n, of, st);
    case 96: return launch<96>(q, x, bf, batch, n, of, st);
    case 112: return launch<112>(q, x, bf, batch, n, of, st);
    case 128: return launch<128>(q, x, bf, batch, n, of, st);
    case 144: return launch<144>(q, x, bf, batch, n, of, st);
    case 160: return launch<160>(q, x, bf, batch, n, of, st);
    case 176: return launch<176>(q, x, bf, batch, n, of, st);
    case 192: return launch<192>(q, x, bf, batch, n, of, st);
    case 208: return launch<208>(q, x, bf, batch, n, of, st);
    case 224: return launch<224>(q, x, bf, batch, n, of, st);
    case 240: return launch<240>(q, x, bf, batch, n, of, st);
    case 256: return launch<256>(q, x, bf, batch, n, of, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
