// Chamfer nearest-neighbour kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the two TPU kernels of zeroshape_tpu/ops/chamfer.py:
//   K2  _nn_kernel (:63), called through _nn_one_way_pallas. For each point a
//       of cloud A: the argmin over cloud B of |a|^2 + |b|^2 - 2 a.b in fp32,
//       the first index on ties. The JAX caller then recomputes the winner's
//       exact distance |a - b|^2 (:240-248); here that refinement is fused
//       into the kernel's epilogue.
//   K3  _nn_min_kernel (:138), called through _nn_min_pallas. The min only,
//       with the cross term a.b formed from bf16-rounded operands and summed
//       in fp32, clamped at 0: no argmin and no refinement. It ranks the
//       rotations of the brute-force coarse stage.
//
// Bounds on the H100, two of them. The JAX CostEstimate counts 9 FLOP a pair
// for K2 and 7 for K3; at the fp32 SIMT peak (67 TFLOP/s) one exact
// brute-force batch, 48 x 10k x 10k pairs, takes 0.645 ms and one coarse
// batch, 192 x 1024 x 1024, 0.021 ms. That bound assumes the product runs on
// the SIMT pipes. The card bound is the largest of: the product [a, 1] .
// [-2b, |b|^2] (depth 4; 3 for K3) at the tensor-core rate (495 TFLOP/s TF32,
// 989 bf16); one comparison a pair at the SIMT issue rate (132 SMs x 4
// schedulers x 32 lanes x 1.98 GHz = 33.5e12 a second); the bytes at 3.35
// TB/s. It is 0.143 ms for the exact batch and 6.0 us for the coarse one,
// both set by the comparisons.
//
// What held the first kernel back (one thread a point of A, B streamed
// through shared memory as float4 (-2b, |b|^2)): 9.75 instructions a pair in
// its inner loop (SASS: LDS, FMUL + 2 FFMA for the cross term, 2 FADD, a
// compare and a select for the min and one for the argmin, and loop
// arithmetic), issued at ~70% of the card's rate: 1.84 ms for the exact
// batch. Only fewer instructions a pair could make it faster.
//
// This design puts the product on the tensor cores and leaves the SIMT pipes
// one FMNMX a pair, with the argmin found lazily.
//
// K2 (wgmma). The comparison value v = |b|^2 - 2 a.b (|a|^2 is constant in a
// row and dropped) is the product of the augmented rows [a, 1] and [-2b,
// |b|^2], each split hi + lo into TF32 (3xTF32: hi.hi + lo.hi + hi.lo, the
// lo.lo term dropped, fp32 accumulation), so v carries ~21 bits. That is 11
// products, two k8 steps: [a_hi, 1, a_lo, 0] . [b_hi, |b|^2_hi, b_hi, 0],
// then [a_hi, 1, 0, 0] . [b_lo, |b|^2_lo, 0, 0]. One warpgroup a block holds
// 128 points of A as the register operand of two 64-row tiles and issues
// wgmma.mma_async m64n64k8 TF32 on 64-column slices of B, which a block
// stages 512 columns at a time in shared memory, converting while it stages
// (no pre-pass), as the K-major unswizzled operand; the next stage's
// coordinates are loaded into registers while the current one is computed.
// Each lane keeps, for each of its 4 rows, the running min over its own
// columns (2 of every 8) with one FMNMX a value, and, at the end of every
// chunk of 128 columns, the chunk in which that min last fell (strict <, so
// the first chunk to reach the final min). That is the lazy argmin: after
// the sweep each lane rescans its 32 columns of that one chunk in fp32 SIMT,
// in the plain version's own arithmetic (|a|^2 + |b|^2) + (-2 a.b) with the
// first index winning, and the four lanes of a row reduce their candidates
// by that value, the lower index winning a tie. The winner's exact
// |a - b|^2 comes from its original coordinates in device memory.
//
// Why the argmin stays the plain version's within the gate (>= 99.9% equal,
// equally near within 1e-5 where not): the tensor-core value differs from
// the exact |b|^2 - 2 a.b by ~1e-7 on unit-scale clouds, so it can pick
// another chunk only between columns that near; inside the chosen chunk and
// across the four lanes the choice is made on the plain version's own fp32
// value. Duplicate points of B give equal values at every stage, so the
// lower index wins. Every point's result is a function of its own
// coordinates and of B alone, whatever row of a tile it lands in.
//
// K3 (mma.sync). One m16n8k16 bf16 product an 8-column tile: [bf16(a), 1, 1,
// 1] . [bf16(-2b), h1, h2, h3], where h1 + h2 + h3 = |b|^2 exactly (three
// bf16 pieces hold fp32's 24 bits; scaling by -2 is exact in bf16), so the
// tensor core returns |b|^2 - 2 bf16(a).bf16(b), summed in fp32. One FMNMX a
// value; the four lanes of a row reduce by shuffles; |a|^2 is added after the
// min (fp32 rounding is monotone, so min_j fl(na + y_j) = fl(na + min_j y_j)),
// then the clamp at 0. B is staged as 4 bytes a lane a column.
//
// What bounds them now (NVIDIA H100 80GB HBM3, 700 W; compare_chamfer.py):
// K2 runs the tensor cores at about a third of the TF32 rate and the issue
// slots at about half: each warpgroup waits for its products before it takes
// their min, and overlapping the two with a second accumulator set made
// ptxas serialise the wgmmas. mma.sync TF32 (k8 + k4 an 8-column tile) was
// slower, and a register-blocked SIMT kernel (8 rows a thread, 3 FFMA + 1
// FMNMX a pair) slower still.
//
// blockIdx.y is the batch element; each cloud has a batch stride in floats,
// 0 for a cloud shared by the whole batch. Ragged edges are masked: columns
// past M hold a far point (|b|^2 = 1e30), rows past N are zeros and are not
// written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

// K2: one warpgroup a block, two 64-row tiles of A (128 points) in
// registers; B staged 512 columns at a time; the lazy argmin's chunk.
constexpr int K2_THREADS = 128;
constexpr int K2_TILES = 2;
constexpr int K2_ROWS = K2_TILES * 64;
constexpr int K2_STAGE = 512;
constexpr int CHUNK = 128;
// K3: 8 warps, each with four 16-row mma tiles (512 points of A a block); B
// staged 1024 columns at a time.
constexpr int K3_WARPS = 8;
constexpr int K3_MT = 4;
constexpr int K3_THREADS = K3_WARPS * 32;
constexpr int K3_ROWS = K3_WARPS * K3_MT * 16;
constexpr int K3_STAGE = 1024;
constexpr float FAR = 1e30f;  // |b|^2 of a column past M

static_assert(K2_STAGE % CHUNK == 0, "a stage holds whole chunks");

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// d = A(16x16, bf16) . B(16x8, bf16), fp32, from zero; the upper half of the
// depth is zero in both operands
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%6}, {%7,%6}, "
      "{%8,%8,%8,%8};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(b0), "f"(0.f));
}

// Load the coordinates of columns j0 + threadIdx.x + i * THREADS (i < PER)
// of B into registers; columns past M are left as they are.
template <int PER, int THREADS>
__device__ __forceinline__ void prefetch(const float* __restrict__ Bc, int j0, int M, float (&pf)[PER][3]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = j0 + threadIdx.x + i * THREADS;
    if (j < M) {
      const float* q = Bc + 3 * (size_t)j;
      pf[i][0] = __ldg(q), pf[i][1] = __ldg(q + 1), pf[i][2] = __ldg(q + 2);
    }
  }
}

// The lazy argmin's end, for the NR rows a lane holds (rows past N are
// computed and not written): the lane rescans its columns 8k + 2t + {0, 1}
// of each row's chunk in the plain version's fp32 arithmetic, (|a|^2 + |b|^2)
// + (-2 a.b), in increasing order with the first index winning; the four
// lanes of a row reduce their candidates by that value, the lower index
// winning a tie; lane t = 0 writes the winner's exact |a - b|^2. The loop over
// the rows is innermost, so the loads of all NR rows are in flight together.
template <int NR>
__device__ __forceinline__ void finish(const float* __restrict__ A, const float* __restrict__ Bc, int N, int M,
                                       const int (&rows)[NR], const int (&chunks)[NR], int t,
                                       float* __restrict__ dist, long long* __restrict__ idx) {
  float ax[NR], ay[NR], az[NR], na[NR], dbest[NR];
  int jbest[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    ax[i] = ay[i] = az[i] = 0.f;
    if (rows[i] < N) {
      const float* p = A + 3 * (size_t)rows[i];
      ax[i] = p[0], ay[i] = p[1], az[i] = p[2];
    }
    na[i] = sq_norm(ax[i], ay[i], az[i]);
    dbest[i] = INFINITY, jbest[i] = M;
  }
#pragma unroll 2
  for (int k = 0; k < CHUNK; k += 8) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = chunks[i] * CHUNK + k + 2 * t + e;
        if (j < M) {
          const float* q = Bc + 3 * (size_t)j;
          const float bx = __ldg(q), by = __ldg(q + 1), bz = __ldg(q + 2);
          const float cross = fmaf(az[i], -2.f * bz, fmaf(ay[i], -2.f * by, __fmul_rn(ax[i], -2.f * bx)));
          const float d = __fadd_rn(__fadd_rn(na[i], sq_norm(bx, by, bz)), cross);
          if (d < dbest[i]) dbest[i] = d, jbest[i] = j;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, dbest[i], off);
      const int oj = __shfl_xor_sync(0xffffffffu, jbest[i], off);
      if (od < dbest[i] || (od == dbest[i] && oj < jbest[i])) dbest[i] = od, jbest[i] = oj;
    }
    if (t == 0 && rows[i] < N) {
      const float* q = Bc + 3 * (size_t)jbest[i];
      dist[rows[i]] = sq_norm(ax[i] - q[0], ay[i] - q[1], az[i] - q[2]);
      idx[rows[i]] = jbest[i];
    }
  }
}

// wgmma descriptor of K2's staged B: K-major, unswizzled; the two 4-value
// halves of the depth lie 128 bytes apart, 8-column groups 512 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(512 >> 4) << 32);
}

// d (+)= A(64x8, tf32, registers) . B(8x64, tf32, shared memory), fp32
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

__global__ void __launch_bounds__(K2_THREADS)
nn_kernel(const float* __restrict__ x1, const float* __restrict__ x2, long long s1, long long s2, int N,
          int M, float* __restrict__ dist, long long* __restrict__ idx) {
  __shared__ __align__(128) float sb[K2_STAGE * 16];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* A = x1 + (size_t)blockIdx.y * (size_t)s1;
  const float* Bc = x2 + (size_t)blockIdx.y * (size_t)s2;
  const int base = blockIdx.x * K2_ROWS + (threadIdx.x >> 5) * 16;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(sb);

  // A fragments: lane (g, t) of warp w holds augmented coordinate t (and
  // t + 4) of rows 16w + g and 16w + g + 8 of each 64-row tile: [a_hi, 1 |
  // a_lo, 0]; the second step reuses the first half with zeros
  uint32_t a[K2_TILES][4];
#pragma unroll
  for (int r = 0; r < K2_TILES; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = base + r * 64 + h * 8 + g;
      const float v = (t < 3 && row < N) ? A[3 * (size_t)row + t] : 0.f;
      const uint32_t hi = t < 3 ? tf32(v) : 0x3f800000u;
      a[r][h] = hi;
      a[r][2 + h] = t < 3 ? tf32(v - __uint_as_float(hi)) : 0u;
    }
  }
  float d[K2_TILES][32], best[K2_TILES][2], prev[K2_TILES][2];
  int chunk[K2_TILES][2];
#pragma unroll
  for (int r = 0; r < K2_TILES; ++r) {
#pragma unroll
    for (int i = 0; i < 32; ++i) d[r][i] = 0.f;
    best[r][0] = best[r][1] = prev[r][0] = prev[r][1] = INFINITY;
    chunk[r][0] = chunk[r][1] = 0;
  }

  constexpr int PER = K2_STAGE / K2_THREADS;
  float pf[PER][3] = {};
  prefetch<PER, K2_THREADS>(Bc, 0, M, pf);
  for (int j0 = 0; j0 < M; j0 += K2_STAGE) {
    // stage the 64-column slices holding a live column: for 8-column group
    // q, 512 bytes at 512q, [step][depth half][column][4 values]
    const int n64 = (min(K2_STAGE, M - j0) + 63) / 64;
    __syncthreads();  // every product of the previous stage has been waited for
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = threadIdx.x + i * K2_THREADS;
      if (p >= n64 * 64) continue;
      float v[4] = {0.f, 0.f, 0.f, FAR};
      if (j0 + p < M) {
        const float bx = pf[i][0], by = pf[i][1], bz = pf[i][2];
        v[0] = -2.f * bx, v[1] = -2.f * by, v[2] = -2.f * bz, v[3] = sq_norm(bx, by, bz);
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[c] = tf32(v[c]), lo[c] = tf32(v[c] - __uint_as_float(hi[c]));
      uint4* blk = reinterpret_cast<uint4*>(sb + (p >> 3) * 128 + (p & 7) * 4);
      blk[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      blk[8] = make_uint4(hi[0], hi[1], hi[2], 0u);
      blk[16] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      blk[24] = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    if (j0 + K2_STAGE < M) prefetch<PER, K2_THREADS>(Bc, j0 + K2_STAGE, M, pf);
    for (int kc = 0; kc < n64; kc += CHUNK / 64) {
      const int kend = min(kc + CHUNK / 64, n64);
      for (int k = kc; k < kend; ++k) {
        const uint64_t desc = wg_desc(sbase + k * 4096);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int r = 0; r < K2_TILES; ++r) {
          wgmma_tf32(d[r], a[r][0], a[r][1], a[r][2], a[r][3], desc, 0);
          wgmma_tf32(d[r], a[r][0], a[r][1], 0u, 0u, desc + (256 >> 4), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int r = 0; r < K2_TILES; ++r) {
#pragma unroll
          for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[r][i])::"memory");  // read after the wait
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            best[r][0] = fminf(best[r][0], fminf(d[r][4 * q], d[r][4 * q + 1]));
            best[r][1] = fminf(best[r][1], fminf(d[r][4 * q + 2], d[r][4 * q + 3]));
          }
        }
      }
      const int c = (j0 + 64 * kc) / CHUNK;  // a row whose min fell in chunk c records it
#pragma unroll
      for (int r = 0; r < K2_TILES; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          chunk[r][h] = best[r][h] < prev[r][h] ? c : chunk[r][h];
          prev[r][h] = best[r][h];
        }
    }
  }
  int rows[2 * K2_TILES], chunks[2 * K2_TILES];
#pragma unroll
  for (int r = 0; r < K2_TILES; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[2 * r + h] = base + r * 64 + h * 8 + g, chunks[2 * r + h] = chunk[r][h];
  finish(A, Bc, N, M, rows, chunks, t, dist + (size_t)blockIdx.y * (size_t)N, idx + (size_t)blockIdx.y * (size_t)N);
}

// K3. Shared memory: column p's bf16 pairs at [4p + t]: (x, y), (z, h1),
// (h2, h3), 0, so lane 4g + t reads column 8k + g of n8-tile k at [32k + lane].
__global__ void __launch_bounds__(K3_THREADS)
nn_min_kernel(const float* __restrict__ x1, const float* __restrict__ x2, long long s1, long long s2, int N,
              int M, float* __restrict__ dist) {
  __shared__ uint32_t sb[K3_STAGE * 4];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* A = x1 + (size_t)blockIdx.y * (size_t)s1;
  const float* Bc = x2 + (size_t)blockIdx.y * (size_t)s2;
  const int base = blockIdx.x * K3_ROWS + (threadIdx.x >> 5) * (K3_MT * 16);

  // A fragments: lane (g, t) holds the pair 2t, 2t + 1 of the augmented rows
  // g and g + 8: (x, y), (z, 1), (1, 1), (0, 0) of [bf16(a), 1, 1, 1, 0, 0]
  uint32_t a[K3_MT][2];
#pragma unroll
  for (int mt = 0; mt < K3_MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = base + mt * 16 + h * 8 + g;
      const bool live = row < N;
      const float* p = A + 3 * (size_t)row;
      a[mt][h] = t == 0   ? bf16x2(live ? p[0] : 0.f, live ? p[1] : 0.f)
                 : t == 1 ? bf16x2(live ? p[2] : 0.f, 1.f)
                 : t == 2 ? bf16x2(1.f, 1.f)
                          : 0u;
    }
  }
  float best[K3_MT][2];
#pragma unroll
  for (int mt = 0; mt < K3_MT; ++mt) best[mt][0] = best[mt][1] = INFINITY;

  for (int j0 = 0; j0 < M; j0 += K3_STAGE) {
    const int n8 = min(K3_STAGE, M - j0 + 7) / 8;
    __syncthreads();
    for (int p = threadIdx.x; p < n8 * 8; p += K3_THREADS) {
      uint4 v = make_uint4(0u, bf16x2(0.f, FAR), 0u, 0u);
      if (j0 + p < M) {
        const size_t j = 3 * (size_t)(j0 + p);
        const float bx = Bc[j], by = Bc[j + 1], bz = Bc[j + 2];
        const float nb = sq_norm(bx, by, bz);
        const float h1 = bf16(nb), h2 = bf16(nb - h1), h3 = bf16(nb - h1 - h2);
        v = make_uint4(bf16x2(-2.f * bx, -2.f * by), bf16x2(-2.f * bz, h1), bf16x2(h2, h3), 0u);
      }
      reinterpret_cast<uint4*>(sb)[p] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < n8; ++k) {
      const uint32_t b = sb[32 * k + lane];
#pragma unroll
      for (int mt = 0; mt < K3_MT; ++mt) {
        float d[4];
        mma_bf16(d, a[mt][0], a[mt][1], b);
        best[mt][0] = fminf(best[mt][0], fminf(d[0], d[1]));
        best[mt][1] = fminf(best[mt][1], fminf(d[2], d[3]));
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < K3_MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = best[mt][h];
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int row = base + mt * 16 + h * 8 + g;
      if (t == 0 && row < N) {
        const float* p = A + 3 * (size_t)row;
        const float d = __fadd_rn(sq_norm(p[0], p[1], p[2]), m);
        dist[(size_t)blockIdx.y * (size_t)N + row] = d > 0.f ? d : 0.f;
      }
    }
  }
}

bool valid(int B, int N, int M) { return B >= 0 && N >= 0 && M >= 1 && B <= 65535; }

}  // namespace

// K2: exact squared distance to, and index of, each point's nearest neighbour.
// x1 [B, N, 3], x2 [B, M, 3] fp32 with batch strides s1, s2 (in floats);
// dist [B, N] fp32, idx [B, N] int64, both contiguous.
extern "C" int zs_nn_one_way(const float* x1, const float* x2, long long s1, long long s2, int B,
                             int N, int M, float* dist, long long* idx, void* stream) {
  if (!valid(B, N, M)) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((N + K2_ROWS - 1) / K2_ROWS, B);
  nn_kernel<<<grid, K2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x1, x2, s1, s2, N, M, dist, idx);
  return (int)cudaGetLastError();
}

// K3: ranking-grade min squared distance (bf16 cross term), dist [B, N] only.
extern "C" int zs_nn_min_fast(const float* x1, const float* x2, long long s1, long long s2, int B,
                              int N, int M, float* dist, void* stream) {
  if (!valid(B, N, M)) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((N + K3_ROWS - 1) / K3_ROWS, B);
  nn_min_kernel<<<grid, K3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x1, x2, s1, s2, N, M, dist);
  return (int)cudaGetLastError();
}
