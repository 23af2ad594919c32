// Chamfer nearest-neighbour kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the two TPU kernels of zeroshape_tpu/ops/chamfer.py:
//   K2  _nn_kernel (:63), called through _nn_one_way_pallas. For each point a
//       of cloud A: the min over cloud B of |a|^2 + |b|^2 - 2 a.b in fp32 and
//       its argmin, the first index on ties. The JAX caller then recomputes
//       the winner's exact distance |a - b|^2 (:240-248); here that
//       refinement is fused into the kernel's epilogue.
//   K3  _nn_min_kernel (:138), called through _nn_min_pallas. The min only,
//       with the cross term a.b formed from bf16-rounded operands and summed
//       in fp32, clamped at 0: no argmin and no refinement. It ranks the
//       rotations of the brute-force coarse stage.
// K3 is K2 with the template flag FAST.
//
// Bound on the H100: operations. The JAX CostEstimate counts 9 FLOP a pair
// for K2 and 7 for K3. A depth-3 product cannot feed a tensor-core MMA
// usefully, so the rate is the fp32 SIMT peak, 67 TFLOP/s. One exact
// brute-force batch, 48 x 10k x 10k pairs, is 4.32e10 FLOP = 0.645 ms; one
// coarse batch, 192 x 1024 x 1024, is 1.41e9 FLOP = 0.021 ms. The bytes (each
// cloud read once, the outputs written once) take a few microseconds.
//
// Design, simple and right first. One thread owns one point of A and keeps
// its running min and argmin in registers. A block of 256 threads walks B in
// tiles of 1024 points staged through shared memory as float4
// (-2x, -2y, -2z, |b|^2): 16 bytes a point, 16 KB a tile. All threads of a
// warp read the same entry at once, a broadcast. blockIdx.y is the batch
// element; each cloud has a batch stride in floats, 0 for a cloud shared by
// the whole batch. Ragged edges are masked, so nothing is padded.
//
// Arithmetic, so that the result matches the plain PyTorch version
// (ops/chamfer.py) and does not depend on where a point lands:
//   |a|^2, |b|^2   (x*x + y*y) + z*z, rounded at each step (no contraction);
//   distance       (|a|^2 + |b|^2) + (-2 a.b). Scaling by -2 is exact, so
//                  this equals |a|^2 + |b|^2 - 2 a.b;
//   K3's cross     bf16(a) . bf16(-2b): each product of two bf16 values is
//                  exact in fp32, so an FMA chain rounds exactly as a sum of
//                  rounded products, ((p_x + p_y) + p_z);
//   K2's refined   (dx*dx + dy*dy) + dz*dz with d = a - b of the winner.
// The min is strict (d < best), so the lowest index wins a tie. Every
// point's result is a function of its own coordinates and cloud B alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;  // points of A per block, one per thread
constexpr int TILE = 1024;    // points of B per shared-memory tile

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ x1, const float* __restrict__ x2, long long s1, long long s2,
          int N, int M, float* __restrict__ dist, long long* __restrict__ idx) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const float* A = x1 + (size_t)b * (size_t)s1;
  const float* Bc = x2 + (size_t)b * (size_t)s2;
  const bool live = i < N;

  float ax = 0.f, ay = 0.f, az = 0.f;
  if (live) {
    ax = A[3 * (size_t)i];
    ay = A[3 * (size_t)i + 1];
    az = A[3 * (size_t)i + 2];
  }
  const float na = sq_norm(ax, ay, az);
  // the cross-term operands: bf16-rounded for K3, as they are for K2
  const float cx = FAST ? to_bf16(ax) : ax;
  const float cy = FAST ? to_bf16(ay) : ay;
  const float cz = FAST ? to_bf16(az) : az;

  float best = INFINITY;
  int arg = 0;
  for (int j0 = 0; j0 < M; j0 += TILE) {
    const int n = min(TILE, M - j0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const size_t j = 3 * (size_t)(j0 + k);
      const float bx = Bc[j], by = Bc[j + 1], bz = Bc[j + 2];
      const float nb = sq_norm(bx, by, bz);
      if (FAST) {
        tile[k] = make_float4(-2.f * to_bf16(bx), -2.f * to_bf16(by), -2.f * to_bf16(bz), nb);
      } else {
        tile[k] = make_float4(-2.f * bx, -2.f * by, -2.f * bz, nb);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float4 q = tile[k];
      const float cross = fmaf(cz, q.z, fmaf(cy, q.y, __fmul_rn(cx, q.x)));
      const float d = __fadd_rn(__fadd_rn(na, q.w), cross);
      if (d < best) {
        best = d;
        if (!FAST) arg = j0 + k;
      }
    }
  }
  if (!live) return;
  const size_t o = (size_t)b * (size_t)N + i;
  if (FAST) {
    dist[o] = best > 0.f ? best : 0.f;
  } else {
    const size_t j = 3 * (size_t)arg;
    dist[o] = sq_norm(ax - Bc[j], ay - Bc[j + 1], az - Bc[j + 2]);
    idx[o] = arg;
  }
}

template <bool FAST>
cudaError_t launch(const float* x1, const float* x2, long long s1, long long s2, int B, int N,
                   int M, float* dist, long long* idx, void* stream) {
  if (B < 0 || N < 0 || M < 1 || B > 65535) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  nn_kernel<FAST><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x1, x2, s1, s2, N, M,
                                                                           dist, idx);
  return cudaGetLastError();
}

}  // namespace

// K2: exact squared distance to, and index of, each point's nearest neighbour.
// x1 [B, N, 3], x2 [B, M, 3] fp32 with batch strides s1, s2 (in floats);
// dist [B, N] fp32, idx [B, N] int64, both contiguous.
extern "C" int zs_nn_one_way(const float* x1, const float* x2, long long s1, long long s2, int B,
                             int N, int M, float* dist, long long* idx, void* stream) {
  return (int)launch<false>(x1, x2, s1, s2, B, N, M, dist, idx, stream);
}

// K3: ranking-grade min squared distance (bf16 cross term), dist [B, N] only.
extern "C" int zs_nn_min_fast(const float* x1, const float* x2, long long s1, long long s2, int B,
                              int N, int M, float* dist, void* stream) {
  return (int)launch<true>(x1, x2, s1, s2, B, N, M, dist, nullptr, stream);
}
