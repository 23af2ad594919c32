// Fused point-stream implicit decoder for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel zeroshape_tpu/ops/implicit_kernel.py:_decoder_kernel
// (called through fused_decode). For every query point it computes what
// Implicit.decode computes, with bf16 matrix products accumulating in fp32,
// fp32 LayerNorms, biases and residual stream:
//   point_proj 3->256;
//   2 x [LN -> qkv -> joint softmax over the L cached latent keys plus the
//        point's own key (8 heads, hd 32) -> proj; LN -> 256->1024->256 exact
//        GELU MLP];
//   final LN; 9-linear softplus(beta 100) skip MLP, skips at {2,4,6}; width-1
//   output = one occupancy logit per point.
//
// Bound on the H100: operations. About 5.0 MFLOP per point (the 2 blocks take
// 3.55, the skip MLP 1.45), i.e. 2.74 TFLOP for the 547,937 points of one
// vox-128 hierarchical decode = 2.8 ms at 989 TFLOP/s bf16. The bytes it must
// move (points in, logits out, 3 MB of bf16 weights, 0.2 MB of caches) take
// microseconds.
//
// Design. The Pallas kernel parks all ~3 MB of bf16 weights in VMEM; an SM has
// 227 KB of shared memory, so here the weights stay in global memory, where
// they sit resident in the 50 MB L2. Each warp streams its 16-column weight
// stripe through a private 3-stage cp.async ring in shared memory (two 16x16
// tiles in flight while the tensor cores work on the third) into WMMA
// 16x16x16 bf16 fragments with fp32 accumulation, reusing each weight
// fragment across all 64 point rows of the block. The activations of a 64-point tile do fit: the fp32 residual
// [64, 256] and a bf16 operand buffer [64, 512] stay in shared memory for the
// whole network. Attention runs one head at a time (K/V read from L2, fp32
// scores [64, L_pad] in shared memory, softmax in place). The 1024-wide MLP
// runs in 128-column chunks: fc1 on the chunk, GELU, then the chunk's share of
// fc2 accumulates into the residual, so [64, 1024] never exists.
//
// Every per-row reduction (LayerNorm, softmax, self score, last linear) is done
// by one warp in a fixed order, and tensor-core products are row-independent,
// so a point's logit does not depend on the tile or row it lands in (the
// hierarchical scatter writes shared boundary points twice and relies on it).
// Shared-memory row strides are padded by 16 bytes so the fragment loads and
// stores do not collide on banks. Matrix products use WMMA (mma.sync), not
// wgmma/TMA: a right and simple first kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int T = 64;  // points per block
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int C = 256;  // channels
constexpr int NH = 8;   // heads
constexpr int HD = 32;  // head dim
constexpr int NB = 2;   // attention blocks
constexpr int HID = 1024;
constexpr int CHUNK = 128;  // fc1 columns per MLP chunk
constexpr int NLIN = 9;     // skip-MLP linears
constexpr int QKV = 3 * HD;  // per-head q|k|v columns
constexpr int NSTAGE = 3;    // cp.async ring depth per warp
// padded shared-memory row strides (elements)
constexpr int LDP = C + 4;        // fp32 residual
constexpr int LDA = 2 * C + 8;    // bf16 operand buffer
constexpr int LDQ = QKV + 4;      // fp32 per-head q|k|v

// Shared-memory layout (bytes); every region starts on a 128-byte boundary.
// The scratch region (fp32 [T][LDS], LDS = max(Lp, CHUNK) + 4) and the
// per-warp cp.async rings follow OFF_SC; their size depends on Lp.
constexpr int OFF_P = 0;                           // fp32 [T][LDP] residual
constexpr int OFF_A = OFF_P + T * LDP * 4;         // bf16 [T][LDA] operands
constexpr int OFF_QKV = OFF_A + T * LDA * 2;       // fp32 [T][LDQ]
constexpr int OFF_QB = OFF_QKV + T * LDQ * 4;      // bf16 [T][HD] q of one head
constexpr int OFF_SSELF = OFF_QB + T * HD * 2;     // fp32 [T] self scores
constexpr int OFF_WSELF = OFF_SSELF + T * 4;       // fp32 [T] self weights
constexpr int OFF_PTS = OFF_WSELF + T * 4;         // fp32 [T][4] points
constexpr int OFF_SC = OFF_PTS + T * 4 * 4;        // fp32 [T][LDS] scratch
constexpr int RING = NSTAGE * 16 * 16;             // bf16 elements per warp ring
constexpr int MAX_LP = 208;  // the most padded latent rows the layout fits
static_assert(OFF_SC + T * (MAX_LP + 4) * 4 + NWARP * RING * 2 <= 232448, "shared memory");
static_assert(OFF_A % 128 == 0 && OFF_QKV % 128 == 0 && OFF_SC % 128 == 0, "region alignment");

}  // namespace

// Device pointers of the packed decoder (ops/implicit_kernel.py builds the
// same struct with ctypes; field order must match).
struct DecoderParams {
  const bf16* point_w;   // [3][C]
  const float* point_b;  // [C]
  const float* ln1;      // [NB][2][C] (scale, bias)
  const bf16* qkv_w;     // [NB][NH][C][QKV] per-head q|k|v columns
  const float* qkv_b;    // [NB][NH][QKV]
  const bf16* proj_w;    // [NB][C][C] (in, out)
  const float* proj_b;   // [NB][C]
  const float* ln2;      // [NB][2][C]
  const bf16* fc1_w;     // [NB][C][HID]
  const float* fc1_b;    // [NB][HID]
  const bf16* fc2_w;     // [NB][HID][C]
  const float* fc2_b;    // [NB][C]
  const float* lnf;      // [2][C]
  const bf16* k_cache;   // [NB][NH][Lp][HD], rows >= L zero
  const bf16* v_cache;   // [NB][NH][Lp][HD]
  const bf16* mlp_w[NLIN];   // l=0: [C][C] trunk rows; skips: [2C][C] rows
                             // [state | trunk]; others [C][C]; last: [C]
  const bf16* mlp_wp[NLIN];  // [3][C] point rows (l=0 and skips), else null
  const float* mlp_b[NLIN];  // [C] ([1] for the last)
};

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// C[T][N] (=|+=) A[T][K] @ B[K][N]; A bf16 in shared memory, B bf16 in global
// memory, C fp32 in shared memory. A warp task is MT row tiles x one
// 16-column stripe, so each B tile is fetched once per MT row tiles; the B
// tiles of a stripe stream through the warp's cp.async ring (`ring`, RING
// elements), NSTAGE - 1 tiles ahead of the tensor cores.
// B_COL: B given column-major (element (k, n) at B[n * ldb + k]).
// ACC: accumulate onto C instead of overwriting it.
template <int MT, bool B_COL, bool ACC>
__device__ void gemm(const bf16* A, int lda, const bf16* B, int ldb, int K, int N, float* Cm,
                     int ldc, bf16* ring) {
  using BLayout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  constexpr int NRG = (T / 16) / MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntask = NRG * (N / 16);
  const int nk = K / 16;
  // each lane copies 16 bytes: half of one 32-byte row of the 16x16 tile,
  // stored in B's own order (rows of n for B_COL, rows of k otherwise)
  const int lr = lane >> 1, lc = (lane & 1) * 8;
  for (int task = warp; task < ntask; task += NWARP) {
    const int r0 = (task % NRG) * MT * 16;
    const int n0 = (task / NRG) * 16;
    auto fetch = [&](int kk) {
      if (kk < nk) {
        const bf16* src = B_COL ? B + (size_t)(n0 + lr) * ldb + kk * 16 + lc
                                : B + (size_t)(kk * 16 + lr) * ldb + n0 + lc;
        cp_async16(ring + (kk % NSTAGE) * 256 + lr * 16 + lc, src);
      }
      cp_async_commit();  // empty groups keep the wait count uniform
    };
#pragma unroll
    for (int kk = 0; kk < NSTAGE - 1; ++kk) fetch(kk);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (ACC) {
        wmma::load_matrix_sync(acc[m], Cm + (r0 + m * 16) * ldc + n0, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc[m], 0.0f);
      }
    }
    for (int kk = 0; kk < nk; ++kk) {
      fetch(kk + NSTAGE - 1);  // into the slot read in iteration kk - 1
      cp_async_wait<NSTAGE - 1>();
      __syncwarp();
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wmma::load_matrix_sync(b, ring + (kk % NSTAGE) * 256, 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + (r0 + m * 16) * lda + kk * 16, lda);
        wmma::mma_sync(acc[m], a, b, acc[m]);
      }
      __syncwarp();  // every lane has read this slot before it is refilled
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      wmma::store_matrix_sync(Cm + (r0 + m * 16) * ldc + n0, acc[m], ldc, wmma::mem_row_major);
  }
  cp_async_wait<0>();
}

// out[t][c] = bf16(LN(x[t]) * scale + bias), eps 1e-6, fp32 statistics;
// x has row stride LDP.
__device__ void layernorm_rows(const float* x, const float* gb, bf16* out, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < T; t += NWARP) {
    float v[C / 32];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      v[i] = x[t * LDP + lane + 32 * i];
      s += v[i];
    }
    const float mu = warp_sum(s) * (1.0f / C);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const float d = v[i] - mu;
      q += d * d;
    }
    const float rs = rsqrtf(warp_sum(q) * (1.0f / C) + 1e-6f);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      out[t * ldo + c] = __float2bfloat16((v[i] - mu) * rs * gb[c] + gb[C + c]);
    }
  }
}

// Joint softmax of each row over the L latent scores and the row's self
// score (both already scaled). Writes the bf16 latent weights in place over
// the first half of the row (row stride 2*lds in bf16 units; zero in
// [L, Lp)) and the self weight to wself.
__device__ void softmax_rows(float* sc, int lds, const float* sself, float* wself, int L, int Lp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int MAXJ = (MAX_LP + 31) / 32;
  for (int t = warp; t < T; t += NWARP) {
    float* row = sc + t * lds;
    float s[MAXJ];
    float m = sself[t];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int l = lane + 32 * j;
      s[j] = (l < L) ? row[l] : -__int_as_float(0x7f800000);  // -inf
      m = fmaxf(m, s[j]);
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      s[j] = (lane + 32 * j < L) ? expf(s[j] - m) : 0.0f;
      sum += s[j];
    }
    const float e_self = expf(sself[t] - m);
    const float inv = 1.0f / (warp_sum(sum) + e_self);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int l = lane + 32 * j;
      if (l < Lp) prow[l] = __float2bfloat16(s[j] * inv);
    }
    if (lane == 0) wself[t] = e_self * inv;
  }
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float softplus100(float x) {
  return x * 100.0f > 20.0f ? x : log1pf(expf(x * 100.0f)) * 0.01f;
}

__global__ void __launch_bounds__(NTHREAD, 1)
    implicit_decoder_kernel(const DecoderParams prm, const float* __restrict__ pts,
                            float* __restrict__ out, int P, int L, int Lp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = (Lp > CHUNK ? Lp : CHUNK) + 4;  // scratch row stride (fp32)
  float* p = reinterpret_cast<float*>(smem + OFF_P);
  bf16* abuf = reinterpret_cast<bf16*>(smem + OFF_A);
  float* qkvs = reinterpret_cast<float*>(smem + OFF_QKV);
  bf16* qb = reinterpret_cast<bf16*>(smem + OFF_QB);
  float* sself = reinterpret_cast<float*>(smem + OFF_SSELF);
  float* wself = reinterpret_cast<float*>(smem + OFF_WSELF);
  float* spts = reinterpret_cast<float*>(smem + OFF_PTS);
  float* sc = reinterpret_cast<float*>(smem + OFF_SC);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* ring = reinterpret_cast<bf16*>(smem + OFF_SC + T * lds * 4) + warp * RING;
  const int row0 = blockIdx.x * T;
  const float scale = 0.17677669529663687f;  // HD ** -0.5

  for (int i = tid; i < T * 4; i += NTHREAD) {
    const int r = row0 + i / 4, j = i % 4;
    spts[i] = (j < 3 && r < P) ? pts[r * 3 + j] : 0.0f;
  }
  __syncthreads();

  // point embedding (K = 3: FMAs on bf16-rounded operands)
  for (int i = tid; i < T * C; i += NTHREAD) {
    const int t = i / C, c = i % C;
    float acc = prm.point_b[c];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc += bf16_round(spts[t * 4 + j]) * __bfloat162float(prm.point_w[j * C + c]);
    p[t * LDP + c] = acc;
  }
  __syncthreads();

  for (int blk = 0; blk < NB; ++blk) {
    layernorm_rows(p, prm.ln1 + blk * 2 * C, abuf, LDA);
    __syncthreads();
    for (int h = 0; h < NH; ++h) {
      const int bh = blk * NH + h;
      gemm<2, false, false>(abuf, LDA, prm.qkv_w + (size_t)bh * C * QKV, QKV, C, QKV, qkvs, LDQ,
                            ring);
      __syncthreads();
      for (int i = tid; i < T * QKV; i += NTHREAD)
        qkvs[(i / QKV) * LDQ + i % QKV] += prm.qkv_b[bh * QKV + i % QKV];
      __syncthreads();
      for (int i = tid; i < T * HD; i += NTHREAD)
        qb[i] = __float2bfloat16(qkvs[(i / HD) * LDQ + i % HD]);
      for (int t = warp; t < T; t += NWARP) {  // lane == head-dim index
        const float s = warp_sum(qkvs[t * LDQ + lane] * qkvs[t * LDQ + HD + lane]);
        if (lane == 0) sself[t] = s * scale;
      }
      __syncthreads();
      const size_t kv = (size_t)bh * Lp * HD;
      gemm<4, true, false>(qb, HD, prm.k_cache + kv, HD, HD, Lp, sc, lds, ring);
      __syncthreads();
      for (int i = tid; i < T * Lp; i += NTHREAD) sc[(i / Lp) * lds + i % Lp] *= scale;
      __syncthreads();
      softmax_rows(sc, lds, sself, wself, L, Lp);
      __syncthreads();
      // latent weights @ V into the (spent) q columns of qkvs
      gemm<1, false, false>(reinterpret_cast<const bf16*>(sc), 2 * lds, prm.v_cache + kv, HD, Lp,
                            HD, qkvs, LDQ, ring);
      __syncthreads();
      for (int i = tid; i < T * HD; i += NTHREAD) {
        const int t = i / HD, d = i % HD;
        const float o = qkvs[t * LDQ + d] + wself[t] * qkvs[t * LDQ + 2 * HD + d];
        abuf[t * LDA + C + h * HD + d] = __float2bfloat16(o);
      }
      __syncthreads();
    }
    gemm<4, false, true>(abuf + C, LDA, prm.proj_w + (size_t)blk * C * C, C, C, C, p, LDP, ring);
    __syncthreads();
    for (int i = tid; i < T * C; i += NTHREAD) p[(i / C) * LDP + i % C] += prm.proj_b[blk * C + i % C];
    __syncthreads();
    layernorm_rows(p, prm.ln2 + blk * 2 * C, abuf, LDA);
    __syncthreads();
    for (int c0 = 0; c0 < HID; c0 += CHUNK) {
      gemm<4, false, false>(abuf, LDA, prm.fc1_w + (size_t)blk * C * HID + c0, HID, C, CHUNK, sc,
                            lds, ring);
      __syncthreads();
      for (int i = tid; i < T * CHUNK; i += NTHREAD) {
        const int t = i / CHUNK, j = i % CHUNK;
        const float y = sc[t * lds + j] + prm.fc1_b[blk * HID + c0 + j];
        abuf[t * LDA + C + j] = __float2bfloat16(gelu_erf(y));
      }
      __syncthreads();
      gemm<4, false, true>(abuf + C, LDA, prm.fc2_w + (size_t)blk * HID * C + (size_t)c0 * C, C,
                           CHUNK, C, p, LDP, ring);
      __syncthreads();
    }
    for (int i = tid; i < T * C; i += NTHREAD) p[(i / C) * LDP + i % C] += prm.fc2_b[blk * C + i % C];
    __syncthreads();
  }

  // trunk feature x = LN(p) in columns [C, 2C); the MLP state lives in [0, C)
  layernorm_rows(p, prm.lnf, abuf + C, LDA);
  __syncthreads();
  for (int l = 0; l < NLIN - 1; ++l) {
    const bool skip = (l == 2 || l == 4 || l == 6);
    gemm<4, false, false>(l == 0 ? abuf + C : abuf, LDA, prm.mlp_w[l], C, skip ? 2 * C : C, C, p,
                          LDP, ring);
    __syncthreads();
    const float s = skip ? 0.70710678118654752f : 1.0f;  // concat / sqrt(2)
    const bf16* wp = prm.mlp_wp[l];
    for (int i = tid; i < T * C; i += NTHREAD) {
      const int t = i / C, c = i % C;
      float y = p[t * LDP + c];
      if (wp != nullptr) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          y += bf16_round(spts[t * 4 + j]) * __bfloat162float(wp[j * C + c]);
      }
      abuf[t * LDA + c] = __float2bfloat16(softplus100(y * s + prm.mlp_b[l][c]));
    }
    __syncthreads();
  }
  // output linear, width 1
  for (int t = warp; t < T; t += NWARP) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      s += __bfloat162float(abuf[t * LDA + c]) * __bfloat162float(prm.mlp_w[NLIN - 1][c]);
    }
    s = warp_sum(s);
    if (lane == 0 && row0 + t < P) out[row0 + t] = s + prm.mlp_b[NLIN - 1][0];
  }
}

size_t smem_bytes(int Lp) {
  return OFF_SC + (size_t)T * ((Lp > CHUNK ? Lp : CHUNK) + 4) * 4 + (size_t)NWARP * RING * 2;
}

}  // namespace

// Logits for P points (pts [P][3] fp32 -> out [P] fp32) against caches of L
// latent keys padded to Lp rows (Lp a multiple of 16, L <= Lp <= MAX_LP).
// Launches on `stream`; returns the launch's cudaError_t (0 = success).
extern "C" int zs_implicit_decode(const DecoderParams* prm, const float* pts, float* out, int P,
                                  int L, int Lp, void* stream) {
  if (L < 1 || L > Lp || Lp > MAX_LP || Lp % 16 != 0) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const size_t smem = smem_bytes(Lp);
  cudaError_t err = cudaFuncSetAttribute(
      implicit_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (P + T - 1) / T;
  implicit_decoder_kernel<<<grid, NTHREAD, smem, static_cast<cudaStream_t>(stream)>>>(
      *prm, pts, out, P, L, Lp);
  return (int)cudaGetLastError();
}
