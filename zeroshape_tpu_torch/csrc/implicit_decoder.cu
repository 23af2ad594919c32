// Fused point-stream implicit decoder for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel zeroshape_tpu/ops/implicit_kernel.py:_decoder_kernel
// (called through fused_decode). For every query point it computes what
// Implicit.decode computes, with bf16 matrix operands accumulating in fp32 and
// fp32 LayerNorms, softmax, self score, biases and residual stream:
//   point_proj 3->256;
//   2 x [LN -> qkv -> joint softmax over the L cached latent keys plus the
//        point's own key (8 heads, hd 32) -> proj; LN -> 256->1024->256 exact
//        erf GELU MLP];
//   final LN; 9-linear softplus(beta 100) skip MLP, skips at {2,4,6} scaled
//   by 1/sqrt(2); width-1 output = one occupancy logit per point.
//
// Bound on the H100: operations. 4,999,168 FLOP a point against L = 197
// latent keys (chip_smoke.decoder_flops), i.e. 2.560 TFLOP for a 512,000-point
// launch = 2.59 ms at 989 TFLOP/s bf16. The bytes it must move are 4.59 MB of
// packed bf16 weight tiles (ops/implicit_kernel.pack_decoder_params), 0.44 MB
// of packed K/V tiles, 16 bytes a point and some 70 KB of fp32 biases and
// LayerNorms: microseconds. What does cost is L2 traffic: every 128-point
// tile streams all 5,029,888 bytes of weight and cache tiles from L2, so a
// 512,000-point launch reads 20.1 GB from L2.
//
// Design (one block per SM, persistent over 128-point tiles):
//  * 3 warpgroups: warps 0-3 and 4-7 are two consumer warpgroups of 64
//    points each; one lane of warp 8 is the producer. Both consumers read
//    every weight tile the producer delivers, so each weight byte fetched
//    from L2 serves 128 points (twice the 64 of the WMMA kernel this
//    replaced). The block keeps looping over tiles, so the producer streams
//    the next tile's first weights while the consumers finish the last one.
//  * Weight ring. pack_decoder_params lays every matrix out on the host in
//    the order the consumers read it, cut into tiles of at most 16 KB, each
//    already in the shared-memory layout the wgmma descriptors name (K-major,
//    64-byte swizzle: 32-deep K chunks of N rows x 64 bytes, 16-byte units of
//    row n XOR-ed with (n / 2) % 4). One lane of the producer warp copies each
//    tile with one cp.async.bulk (1-D, no tensor map) into a 6-stage ring of
//    16 KB stages; a "full" mbarrier per stage carries the byte count, an
//    "empty" one collects an arrive from each of the 8 consumer warps once
//    their wgmmas on the stage have completed. Consumers never compute a
//    weight address. The K/V caches are packed per call into the same tile
//    layout (fused_decode) and go through the same ring.
//  * Tensor cores through wgmma.mma_async m64nNk16 (bf16 in, fp32
//    accumulate): activations (A) from shared memory or from registers, B
//    from the ring through descriptors. Products: qkv for two heads at once
//    (N = 192: four products a block instead of eight of N = 96); the scores
//    of a head as one 64 x 208 wgmma whose fp32 fragment is scaled, masked
//    and soft-maxed in registers (the joint softmax with the point's own key)
//    and whose probabilities, converted to bf16, are the register A operand
//    of P @ V (as FlashAttention-3 does); proj, fc1, fc2 and the skip MLP at
//    N = 256 or N = 64. The MLP's 1024-wide hidden layer runs in 64-column
//    chunks: fc1 (N = 64) -> bias, GELU, bf16 in registers -> the A operand
//    of that chunk's fc2 product, which accumulates straight into the
//    residual's registers. [64, 1024] never exists.
//  * Budget. Registers: each of the SM's 4 quadrants holds 16,384 registers
//    and one warp of each warpgroup, so 384 threads start at 168 a thread;
//    setmaxnreg moves the producer warpgroup down to 40 and the consumers up
//    to 232 (2 x 232 + 40 = 504 of 512 a lane). A consumer thread holds the
//    fp32 residual of its 2 rows x 64 columns in its N = 256 accumulator
//    (128 registers) in the MLP and the skip MLP; during attention (scores
//    104 + the head pair's q, k.q and v 52 + P@V 16) it parks the residual
//    in a 128 KB global slot of its block (L2-resident, 0.5 MB of extra L2
//    traffic per tile against 5 MB of weights). Shared memory: ring 96 KB +
//    per consumer two bf16 [64, 256] A buffers (32 KB each: LayerNorm
//    outputs and MLP state; attention outputs and the trunk feature) =
//    224 KB + barriers, within 227 KB. ptxas reports 8 bytes of spill.
//    Four things keep it there, each of which alone spilled kilobytes:
//    accumulators a product overwrites are zeroed first; the parking slot is
//    written and read with volatile asm; per-column parameters are read
//    through pointers offset once per thread, paced by warp barriers; and
//    the elementwise math is branch-free.
//  * Epilogues. Once the products ran on the tensor cores, the elementwise
//    work between them set the kernel's time: the library's expf, erff and
//    log1pf spent 10-30 instructions and a branch an element. Softmax,
//    softplus and GELU now use the special-function unit's 2^x and log2 and
//    an erf of 1.5e-7 error, a few instructions an element (their errors are
//    far below the bf16 rounding each output takes next).
//  * Overlap. The two consumers run free against the ring (each releases a
//    stage when its own wgmmas are done), so one warpgroup's LayerNorm,
//    softmax, GELU or softplus epilogue runs while the other's product is on
//    the tensor cores; no explicit ping-pong ordering is imposed, because
//    both consume the same tile stream and can drift apart by the ring's
//    depth. Within a warpgroup the next tile's wgmmas are issued before the
//    previous tile's are waited on.
//  * Sample axis (zs_implicit_decode_batched, the counterpart of the JAX
//    fused_decode_batched). A launch takes B samples of P points, each with
//    its own packed caches; the persistent loop walks B x ntiles work items
//    (sample = item / ntiles), the producer streams the item's sample's K/V
//    tiles and the consumers offset the item's points and logits by
//    sample x P. The weights are shared, so a batch costs one launch and
//    one grid fill instead of B.
//  * Profiling. Built with -DZS_PROFILE (profile_k1.py), the first thread of
//    each consumer warpgroup adds the cycles of each phase to a counter.
//
// Kept properties. Every per-row reduction (LayerNorm, softmax, self score,
// last linear) runs over a row's 4 quad lanes in a fixed order (each lane's
// 64 columns in order, then xor-shuffles 1 and 2), and tensor-core products
// are row-independent, so a point's logit does not depend on the tile, row or
// warpgroup it lands in (the hierarchical scatter writes shared boundary
// points twice and relies on it), and two launches on the same input give
// bit-equal logits: nothing is summed with atomics. Rows past P are computed
// on zero points and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int C = 256;  // channels
constexpr int NH = 8;   // heads
constexpr int HD = 32;  // head dim
constexpr int NB = 2;   // attention blocks
constexpr int HID = 1024;
constexpr int NLIN = 9;  // skip-MLP linears
constexpr int FC_CHUNK = 64;  // fc1 columns per MLP chunk
constexpr int ROWS = 64;      // points per consumer warpgroup
constexpr int NCONS = 2;      // consumer warpgroups
constexpr int TILE_P = ROWS * NCONS;
constexpr int NTHREAD = (NCONS + 1) * 128;  // + the producer warpgroup
// registers a thread after setmaxnreg: each of the SM's 4 quadrants holds one
// warp of every warpgroup, 2 x 232 + 40 = 504 of its 512 registers a lane
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
static_assert(NCONS * CONSUMER_REGS + PRODUCER_REGS <= 512, "register file");
constexpr int MAX_LP = 208;  // latent keys the score product covers (N of one wgmma)
constexpr int V_KEYS = 224;  // keys in a packed V tile (7 chunks of 32)

// tile bytes of the weight / cache stream (see pack_decoder_params)
constexpr int QKV_TILE = 32 * 192 * 2;        // 32 K rows x (q|k|v of 2 heads)
constexpr int K_TILE = MAX_LP * HD * 2;       // K^T of one head: 32 K rows x 208 keys
constexpr int V_TILE = V_KEYS * HD * 2;       // V of one head: 224 K rows x 32
constexpr int W_TILE = 16384;                 // proj, fc1, fc2, skip MLP tiles
constexpr int CACHE_HEAD = K_TILE + V_TILE;
constexpr int CACHE_BYTES = NB * NH * CACHE_HEAD;  // one sample's packed K/V tiles

constexpr int NSTAGE = 6;
constexpr int STAGE = 16384;
constexpr int ABYTES = ROWS * C * 2;  // one bf16 [64, 256] A buffer
constexpr int OFF_BUF = NSTAGE * STAGE;           // per consumer: abuf, obuf
constexpr int OFF_BAR = OFF_BUF + NCONS * 2 * ABYTES;
constexpr int SMEM_BYTES = OFF_BAR + 2 * NSTAGE * 8 + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "shared memory");
static_assert(QKV_TILE <= STAGE && K_TILE <= STAGE && V_TILE <= STAGE, "stage size");

constexpr int PARK_FLOAT2 = ROWS * C / 2;  // float2 a consumer parks

// dynamic shared memory; its 1024-aligned start holds the ring, the A
// buffers and the barriers at the offsets above
extern __shared__ __align__(1024) unsigned char smem_raw[];

#ifdef ZS_PROFILE
__device__ unsigned long long zs_prof[24];
#define PROF_INIT() long long prof_t = clock64()
#define PROF(k)                                                                              \
  do {                                                                                       \
    long long now = clock64();                                                               \
    if (tid == 0) atomicAdd(&zs_prof[k], (unsigned long long)(now - prof_t));                \
    prof_t = now;                                                                            \
  } while (0)
#else
#define PROF_INIT()
#define PROF(k)
#endif

}  // namespace

// Device pointers of the packed decoder (ops/implicit_kernel.py builds the
// same struct with ctypes; field order must match).
struct DecoderParams {
  const bf16* stream;    // weight tiles in consumption order (4,587,520 bytes)
  const bf16* caches;    // K/V tiles [B][NB][NH]{K tile, V tile}, one block a sample
  const bf16* point_w;   // [3][C]
  const float* point_b;  // [C]
  const float* ln1;      // [NB][2][C] (scale, bias)
  const float* qkv_b;    // [NB][NH][3 * HD] per-head q|k|v
  const float* proj_b;   // [NB][C]
  const float* ln2;      // [NB][2][C]
  const float* fc1_b;    // [NB][HID]
  const float* fc2_b;    // [NB][C]
  const float* lnf;      // [2][C]
  const bf16* out_w;     // [C] the width-1 last linear
  const bf16* mlp_wp[NLIN];  // [3][C] point rows (l = 0 and skips), else null
  const float* mlp_b[NLIN];  // [C] ([1] for the last)
};

namespace {

// ---------------------------------------------------------------------------
// PTX wrappers: shared-memory addresses, mbarriers, bulk copies, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A wait
// that lasts some 2^35 cycles (about 20 s) means a lost arrive: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy shared-memory writes become visible to wgmma (async proxy)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over one consumer warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// wgmma descriptor of a K-major, 64-byte-swizzled operand whose 8-row groups
// lie 512 bytes apart (rows of 64 bytes); the leading offset is unused.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching registers an in-flight wgmma owns: every
// accumulator and register A operand is passed through one of these after
// the last wgmma_wait of its product
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}


// ---- generated wgmma wrappers (one per shape the kernel issues) ----
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);
template <>
__device__ __forceinline__ void mma_ss<256>(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss<192>(float (&d)[96], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<208>(float (&d)[104], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103}, {%104, %105, %106, %107}, %108, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// The weight ring, consumer side
// ---------------------------------------------------------------------------

struct Ring {
  uint32_t base;  // stage 0
  uint32_t bars;  // full[NSTAGE] then empty[NSTAGE]
  int stage;
  uint32_t phase;
};

__device__ __forceinline__ uint32_t ring_acquire(const Ring& r) {
  mbar_wait(r.bars + r.stage * 8, r.phase);
  return r.base + r.stage * STAGE;
}

__device__ __forceinline__ void ring_release(const Ring& r, int stage) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.bars + (NSTAGE + stage) * 8);
}

__device__ __forceinline__ void ring_advance(Ring& r) {
  if (++r.stage == NSTAGE) {
    r.stage = 0;
    r.phase ^= 1;
  }
}

// The residual's parking slot in global memory. Volatile asm, so that the
// compiler cannot forward the stored values to the loads after attention and
// keep the residual in registers all the same.
__device__ __forceinline__ void park_store(float2* p, float a, float b) {
  asm volatile("st.global.cg.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void park_load(const float2* p, float& a, float& b) {
  asm volatile("ld.global.cg.v2.f32 {%0, %1}, [%2];\n" : "=f"(a), "=f"(b) : "l"(p) : "memory");
}

// A product that overwrites its accumulator still reads it (the wgmma asm
// names it "+f"): zero it, or the uninitialised array is carried around the
// enclosing loop as a live value and the registers run out.
template <int M>
__device__ __forceinline__ void zero_unless(float (&acc)[M], bool accumulate) {
  if (!accumulate) {
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = 0.0f;
  }
}

// acc (=|+=) A @ B over `ntiles` ring tiles of KPT k-steps each. A is a
// K-major swizzled [64, K] bf16 buffer in shared memory: k-step ks (16 deep)
// lies at a0 for ks < 16 and a1 for ks >= 16 (the two halves of a K = 512
// skip layer). A tile's k-step kk lies at (kk / 2) * BCHUNK + (kk % 2) * 32.
template <int N, int KPT, int BCHUNK>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2], uint32_t a0, uint32_t a1, int ntiles, Ring& ring,
                                        bool accumulate) {
  zero_unless(acc, accumulate);
  wgmma_fence();
  int prev = -1;
#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const uint32_t b = ring_acquire(ring);
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int ks = i * KPT + kk;
      const uint32_t a = (ks < 16 ? a0 : a1) + ((ks & 15) >> 1) * 4096 + (ks & 1) * 32;
      mma_ss<N>(acc, desc(a), desc(b + (kk >> 1) * BCHUNK + (kk & 1) * 32), (accumulate || ks > 0) ? 1 : 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      ring_release(ring, prev);
    }
    prev = ring.stage;
    ring_advance(ring);
  }
  wgmma_wait<0>();
  ring_release(ring, prev);
  fence_regs(acc);
}

// acc (=|+=) A @ B with A in registers (KS k-steps of m64k16 fragments) over
// NT ring tiles of KPT k-steps each; B layout as in gemm_ss.
template <int N, int KS, int NT, int KPT, int BCHUNK>
__device__ __forceinline__ void gemm_rs(float (&acc)[N / 2], uint32_t (&a)[KS][4], Ring& ring, bool accumulate) {
  static_assert(NT * KPT == KS, "k-steps");
  zero_unless(acc, accumulate);
  wgmma_fence();
  int prev = -1;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const uint32_t b = ring_acquire(ring);
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int ks = i * KPT + kk;
      mma_rs<N>(acc, a[ks], desc(b + (kk >> 1) * BCHUNK + (kk & 1) * 32), (accumulate || ks > 0) ? 1 : 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      ring_release(ring, prev);
    }
    prev = ring.stage;
    ring_advance(ring);
  }
  wgmma_wait<0>();
  ring_release(ring, prev);
  fence_regs(acc);
  fence_regs(a);
}

// ---------------------------------------------------------------------------
// Fragment helpers. A thread of warp w (of its warpgroup), lane 4g + t, holds
// the accumulator entries d[4j + q] at row 16w + g (q < 2) or 16w + g + 8
// (q >= 2) and column 8j + 2t + (q & 1).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Per-thread addressing. A thread's columns are 8j + 2t and 8j + 2t + 1 for
// j < N / 8. Every per-column parameter is read through a pointer already
// offset by 2t, so that each load of an epilogue carries a compile-time
// offset (indices computed per load kept ~100 addresses live and spilled).
__device__ __forceinline__ float2 ld2(const float* p2t, int j) {
  float2 v;
  asm volatile("ld.global.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "l"(p2t + 8 * j) : "memory");
  return v;
}
__device__ __forceinline__ float2 ld2(const bf16* p2t, int j) {
  uint32_t v;
  asm volatile("ld.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p2t + 8 * j) : "memory");
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ float ld1(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}
// Epilogues read up to 256 parameters a thread while the 128-register
// residual is live. Left alone, the scheduler issues them all up front and
// the registers spill; a warp barrier every 4 column groups keeps at most 4
// groups' loads in flight (the loads are plain, coherent ones, which may not
// cross it).
__device__ __forceinline__ void pace(int j) {
  if ((j & 3) == 3) __syncwarp();
}

// Byte offsets, within a K-major swizzled bf16 [64, 256] A buffer, of the
// thread's column pair (row ra + 8h, 8j + 2t): the row's start + 4t, plus
// the 16-byte unit j % 4 XOR-ed with (row / 2) % 4, plus (j / 4) * 4096.
struct PairOffsets {
  uint32_t row[2], swz[2];
  __device__ __forceinline__ PairOffsets(int ra, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = (ra + 8 * h) * 64 + 4 * t;
      swz[h] = ((ra + 8 * h) >> 1) & 3;
    }
  }
  __device__ __forceinline__ void store(unsigned char* buf, int h, int j, float a, float b) const {
    const uint32_t off = row[h] + (((j & 3) ^ swz[h]) << 4) + (j >> 2) * 4096;
    *reinterpret_cast<uint32_t*>(buf + off) = pack_bf16(a, b);
  }
};

// bf16(LN(x) * scale + bias) of the thread's two rows of the fragment x into
// buf; eps 1e-6, fp32 statistics; gb2t = the [scale | bias] vectors + 2t
__device__ __forceinline__ void layernorm_store(const float (&x)[128], const float* gb2t, unsigned char* buf,
                                                const PairOffsets& po) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) s += x[4 * j + 2 * h] + x[4 * j + 2 * h + 1];
    const float mu = quad_sum(s) * (1.0f / C);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float d0 = x[4 * j + 2 * h] - mu, d1 = x[4 * j + 2 * h + 1] - mu;
      q += d0 * d0 + d1 * d1;
    }
    const float rs = rsqrtf(quad_sum(q) * (1.0f / C) + 1e-6f);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 g = ld2(gb2t, j), b = ld2(gb2t + C, j);
      po.store(buf, h, j, (x[4 * j + 2 * h] - mu) * rs * g.x + b.x, (x[4 * j + 2 * h + 1] - mu) * rs * g.y + b.y);
      pace(j);
    }
  }
}

// x[., col] += bias2t[col] (N = 256 fragment)
__device__ __forceinline__ void add_bias(float (&x)[128], const float* bias2t) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 b = ld2(bias2t, j);
    x[4 * j] += b.x;
    x[4 * j + 1] += b.y;
    x[4 * j + 2] += b.x;
    x[4 * j + 3] += b.y;
    pace(j);
  }
}

// x[col] += sum_k bf16(point_k) * w[k][col] for the thread's columns, rows r
// and r + 8 (points past P are 0); w2t = w + 2t. The points are read again at
// each use rather than held in registers.
__device__ __forceinline__ void add_point_rows(float (&x)[128], const float* __restrict__ pts, int P, int r,
                                               const bf16* w2t) {
  float pt[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      pt[h][k] = r + 8 * h < P ? bf16_round(ld1(pts + (size_t)(r + 8 * h) * 3 + k)) : 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float2 w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = ld2(w2t + k * C, j);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float y = x[4 * j + q];
#pragma unroll
      for (int k = 0; k < 3; ++k) y += pt[q >> 1][k] * ((q & 1) ? w[k].y : w[k].x);
      x[4 * j + q] = y;
    }
    pace(j);
  }
}

// Elementwise math on the special-function unit: 2^x and log2(x), flushing
// denormals, one instruction each (the library's expf / erff / log1pf spend
// 10-30 instructions and branches an element, which made the epilogues the
// kernel's bottleneck). Their errors (~2 ulp) sit far below the bf16
// rounding every one of these outputs goes through before the next product.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// GELU with the error function (not the tanh form): erf by Abramowitz and
// Stegun 7.1.26, |error| <= 1.5e-7 (erff's own is ~1.2e-7), branch-free:
// for z = |x| / sqrt(2), erf(z) = 1 - poly(t) e^(-z^2), t = 1 / (1 + p z).
__device__ __forceinline__ float gelu_erf(float x) {
  const float z = fabsf(x) * 0.70710678118654752f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, z, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f), -0.284496736f),
               0.254829592f);
  const float tail = poly * ex2(-z * z * LOG2E);  // 1 - erf(z)
  return 0.5f * x * (x >= 0.0f ? 2.0f - tail : tail);
}

// softplus with beta 100 and threshold 20, as torch's, branch-free
__device__ __forceinline__ float softplus100(float x) {
  const float y = x * 100.0f;
  const float soft = lg2(1.0f + ex2(fminf(y, 20.0f) * LOG2E)) * (0.01f / LOG2E);
  return y > 20.0f ? x : soft;
}

// ---------------------------------------------------------------------------
// The producer: the consumers' read order, tile by tile
// ---------------------------------------------------------------------------

struct Producer {
  uint32_t base, bars;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ void put(const unsigned char* src, uint32_t bytes) {
    mbar_wait(bars + (NSTAGE + stage) * 8, phase ^ 1);  // the consumers released the stage
    mbar_expect_tx(bars + stage * 8, bytes);
    bulk_copy(base + stage * STAGE, src, bytes, bars + stage * 8);
    if (++stage == NSTAGE) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void produce(const DecoderParams& prm, int ntiles, int nitems) {
  Producer pr;
  pr.base = (smem_u32(smem_raw) + 1023) & ~1023u;
  pr.bars = pr.base + OFF_BAR;
  pr.stage = 0;
  pr.phase = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    // work item = sample x tile: the sample's own K/V tiles, the shared weights
    const unsigned char* caches =
        reinterpret_cast<const unsigned char*>(prm.caches) + (size_t)(item / ntiles) * CACHE_BYTES;
    const unsigned char* w = reinterpret_cast<const unsigned char*>(prm.stream);
#pragma unroll 1
    for (int blk = 0; blk < NB; ++blk) {
#pragma unroll 1
      for (int hp = 0; hp < NH / 2; ++hp) {
        for (int i = 0; i < C / 32; ++i, w += QKV_TILE) pr.put(w, QKV_TILE);
        for (int e = 0; e < 2; ++e) {
          const unsigned char* kv = caches + (size_t)(blk * NH + 2 * hp + e) * CACHE_HEAD;
          pr.put(kv, K_TILE);
          pr.put(kv + K_TILE, V_TILE);
        }
      }
      for (int i = 0; i < C / 32; ++i, w += W_TILE) pr.put(w, W_TILE);  // proj
#pragma unroll 1
      for (int c = 0; c < HID / FC_CHUNK; ++c)
        for (int i = 0; i < FC_CHUNK / 16; ++i, w += W_TILE) pr.put(w, W_TILE);  // fc1, then fc2 tiles
    }
#pragma unroll 1
    for (int l = 0; l < NLIN - 1; ++l) {
      const int n = (l == 2 || l == 4 || l == 6) ? 2 * C / 32 : C / 32;
      for (int i = 0; i < n; ++i, w += W_TILE) pr.put(w, W_TILE);
    }
  }
}

// ---------------------------------------------------------------------------
// The consumers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void consume(const DecoderParams& prm, const float* __restrict__ pts,
                                        float* __restrict__ out, int P, int L, float2* scratch, int ntiles,
                                        int nitems) {
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int ra = (tid >> 5) * 16 + g;  // the thread's rows: ra and ra + 8
  const int c2 = 2 * t;                // its first column in each group of 8
  unsigned char* abuf_p = smem + OFF_BUF + wg * 2 * ABYTES;
  unsigned char* obuf_p = abuf_p + ABYTES;
  const uint32_t abuf = base + OFF_BUF + wg * 2 * ABYTES, obuf = abuf + ABYTES;
  const PairOffsets po(ra, t);
  float2* park = scratch + (size_t)(blockIdx.x * NCONS + wg) * PARK_FLOAT2 + tid;
  Ring ring{base, base + OFF_BAR, 0, 0};
  const float scale = 0.17677669529663687f;  // HD ** -0.5
  const float ninf = -__int_as_float(0x7f800000);
  const int Lt = L - c2;  // key 8j + 2t + q is a latent key iff 8j + q < Lt
  PROF_INIT();

#pragma unroll 1
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    // work item = sample x tile; a sample's points and logits start at sample x P
    const int sample = item / ntiles;
    const size_t soff = (size_t)sample * P;
    const int row0 = (item - sample * ntiles) * TILE_P + wg * ROWS;

    // point embedding: the residual lives in R, an N = 256 accumulator
    float R[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) R[i] = 0.0f;
    add_bias(R, prm.point_b + c2);
    add_point_rows(R, pts + soff * 3, P, row0 + ra, prm.point_w + c2);
    PROF(0);

#pragma unroll 1
    for (int blk = 0; blk < NB; ++blk) {
      wg_bar(wg);  // the previous reads of abuf are done in every warp
      layernorm_store(R, prm.ln1 + blk * 2 * C + c2, abuf_p, po);
#pragma unroll
      for (int i = 0; i < 64; ++i) park_store(park + i * 128, R[2 * i], R[2 * i + 1]);
      proxy_fence();
      wg_bar(wg);
      PROF(1);

#pragma unroll 1
      for (int hp = 0; hp < NH / 2; ++hp) {
        // q | k | v of heads 2hp and 2hp + 1: columns 96e + [0, 32), [32, 64), [64, 96)
        float Q[96];
        gemm_ss<192, 2, 0>(Q, abuf, abuf, C / 32, ring, false);
        PROF(2);
        const float* qb = prm.qkv_b + (blk * NH + 2 * hp) * 3 * HD + c2;
#pragma unroll
        for (int j = 0; j < 24; ++j) {
          const float2 b = ld2(qb, j);
          Q[4 * j] += b.x;
          Q[4 * j + 1] += b.y;
          Q[4 * j + 2] += b.x;
          Q[4 * j + 3] += b.y;
          pace(j);
        }
        uint32_t qf[2][2][4];  // bf16 q as m64k16 A fragments
        float ss[2][2], vs[2][16];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int qj = 4 * (12 * e + jj), kj = 4 * (12 * e + 4 + jj), vj = 4 * (12 * e + 8 + jj);
            s0 += Q[qj] * Q[kj] + Q[qj + 1] * Q[kj + 1];
            s1 += Q[qj + 2] * Q[kj + 2] + Q[qj + 3] * Q[kj + 3];
#pragma unroll
            for (int q = 0; q < 4; ++q) vs[e][4 * jj + q] = Q[vj + q];
          }
          ss[e][0] = quad_sum(s0) * scale;
          ss[e][1] = quad_sum(s1) * scale;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int a = 4 * (12 * e + 2 * kk), b = a + 4;
            qf[e][kk][0] = pack_bf16(Q[a], Q[a + 1]);
            qf[e][kk][1] = pack_bf16(Q[a + 2], Q[a + 3]);
            qf[e][kk][2] = pack_bf16(Q[b], Q[b + 1]);
            qf[e][kk][3] = pack_bf16(Q[b + 2], Q[b + 3]);
          }
        }
        PROF(3);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // scores against the 208 (padded) latent keys: one 64 x 208 wgmma
          float S[104];
          gemm_rs<208, 2, 1, 2, 0>(S, qf[e], ring, false);
          PROF(4);
          // raw scores: masked past L, their max, then exp2 of (s * scale - m) * log2(e)
          float m0 = ninf, m1 = ninf;
#pragma unroll
          for (int j = 0; j < 26; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float v = 8 * j + (q & 1) < Lt ? S[4 * j + q] : ninf;
              S[4 * j + q] = v;
              if (q < 2) m0 = fmaxf(m0, v);
              else m1 = fmaxf(m1, v);
            }
          m0 = fmaxf(quad_max(m0) * scale, ss[e][0]) * LOG2E;
          m1 = fmaxf(quad_max(m1) * scale, ss[e][1]) * LOG2E;
          float z0 = 0.0f, z1 = 0.0f;
#pragma unroll
          for (int j = 0; j < 26; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float v = ex2(fmaf(S[4 * j + q], scale * LOG2E, q < 2 ? -m0 : -m1));
              S[4 * j + q] = v;
              if (q < 2) z0 += v;
              else z1 += v;
            }
          const float e0 = ex2(fmaf(ss[e][0], LOG2E, -m0)), e1 = ex2(fmaf(ss[e][1], LOG2E, -m1));
          const float inv0 = __fdividef(1.0f, quad_sum(z0) + e0), inv1 = __fdividef(1.0f, quad_sum(z1) + e1);
          uint32_t pf[13][4];  // bf16 probabilities as A fragments of P @ V
#pragma unroll
          for (int kk = 0; kk < 13; ++kk) {
            const int a = 8 * kk;
            pf[kk][0] = pack_bf16(S[a] * inv0, S[a + 1] * inv0);
            pf[kk][1] = pack_bf16(S[a + 2] * inv1, S[a + 3] * inv1);
            pf[kk][2] = pack_bf16(S[a + 4] * inv0, S[a + 5] * inv0);
            pf[kk][3] = pack_bf16(S[a + 6] * inv1, S[a + 7] * inv1);
          }
          PROF(5);
          float O[16];
          gemm_rs<32, 13, 1, 13, 32 * 64>(O, pf, ring, false);
          PROF(6);
          const float w0 = e0 * inv0, w1 = e1 * inv1;  // the point's own key
          // head 2hp + e owns columns [32 (2hp + e), +32): column groups 4 (2hp + e) + jj
          unsigned char* ob = obuf_p + (2 * hp + e) * 4096;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            po.store(ob, 0, jj, O[4 * jj] + w0 * vs[e][4 * jj], O[4 * jj + 1] + w0 * vs[e][4 * jj + 1]);
            po.store(ob, 1, jj, O[4 * jj + 2] + w1 * vs[e][4 * jj + 2], O[4 * jj + 3] + w1 * vs[e][4 * jj + 3]);
          }
          PROF(7);
        }
      }
      proxy_fence();
      wg_bar(wg);
      PROF(8);

      // residual + proj(attention), straight into the residual's registers
#pragma unroll
      for (int i = 0; i < 64; ++i) park_load(park + i * 128, R[2 * i], R[2 * i + 1]);
      PROF(9);
      gemm_ss<256, 2, 0>(R, obuf, obuf, C / 32, ring, true);
      add_bias(R, prm.proj_b + blk * C + c2);
      PROF(10);

      layernorm_store(R, prm.ln2 + blk * 2 * C + c2, abuf_p, po);
      proxy_fence();
      wg_bar(wg);
      PROF(11);
      // MLP in FC_CHUNK-column chunks of the hidden layer
#pragma unroll 1
      for (int ch = 0; ch < HID / FC_CHUNK; ++ch) {
        constexpr int FC1_KPT = 2 * STAGE / (FC_CHUNK * 64);  // k-steps in a 16 KB fc1 tile
        // the chunk's fc1 bias is loaded before its product, which hides the load
        float2 b1[FC_CHUNK / 8];
#pragma unroll
        for (int j = 0; j < FC_CHUNK / 8; ++j) b1[j] = ld2(prm.fc1_b + blk * HID + ch * FC_CHUNK + c2, j);
        float H[FC_CHUNK / 2];
        gemm_ss<FC_CHUNK, FC1_KPT, FC_CHUNK * 64>(H, abuf, abuf, 16 / FC1_KPT, ring, false);
        PROF(12);
#pragma unroll
        for (int j = 0; j < FC_CHUNK / 8; ++j) {
          const float2 b = b1[j];
          H[4 * j] = gelu_erf(H[4 * j] + b.x);
          H[4 * j + 1] = gelu_erf(H[4 * j + 1] + b.y);
          H[4 * j + 2] = gelu_erf(H[4 * j + 2] + b.x);
          H[4 * j + 3] = gelu_erf(H[4 * j + 3] + b.y);
        }
        uint32_t hf[FC_CHUNK / 16][4];
#pragma unroll
        for (int kk = 0; kk < FC_CHUNK / 16; ++kk) {
          const int a = 8 * kk;
          hf[kk][0] = pack_bf16(H[a], H[a + 1]);
          hf[kk][1] = pack_bf16(H[a + 2], H[a + 3]);
          hf[kk][2] = pack_bf16(H[a + 4], H[a + 5]);
          hf[kk][3] = pack_bf16(H[a + 6], H[a + 7]);
        }
        PROF(13);
        gemm_rs<256, FC_CHUNK / 16, FC_CHUNK / 32, 2, 0>(R, hf, ring, true);
        PROF(14);
      }
      add_bias(R, prm.fc2_b + blk * C + c2);
    }

    // trunk feature x = LN(p) into obuf; the MLP state goes to abuf
    wg_bar(wg);
    layernorm_store(R, prm.lnf + c2, obuf_p, po);
    proxy_fence();
    wg_bar(wg);
    PROF(15);
#pragma unroll 1
    for (int l = 0; l < NLIN - 1; ++l) {
      const bool skip = (l == 2 || l == 4 || l == 6);
      // rows [state | trunk] for skips (abuf, then obuf); the trunk alone for l = 0
      gemm_ss<256, 2, 0>(R, l == 0 ? obuf : abuf, obuf, skip ? 2 * C / 32 : C / 32, ring, false);
      PROF(16);
      if (prm.mlp_wp[l] != nullptr) add_point_rows(R, pts + soff * 3, P, row0 + ra, prm.mlp_wp[l] + c2);
      PROF(17);
      const float s = skip ? 0.70710678118654752f : 1.0f;  // concat / sqrt(2)
      const float* b = prm.mlp_b[l] + c2;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 bj = ld2(b, j);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          R[4 * j + q] = softplus100(R[4 * j + q] * s + ((q & 1) ? bj.y : bj.x));
        pace(j);
      }
      PROF(18);
      if (l < NLIN - 2) {
        wg_bar(wg);  // every warp's wgmmas have read abuf
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          po.store(abuf_p, 0, j, R[4 * j], R[4 * j + 1]);
          po.store(abuf_p, 1, j, R[4 * j + 2], R[4 * j + 3]);
        }
        proxy_fence();
        wg_bar(wg);
      }
      PROF(19);
    }
    // the width-1 output linear, in fp32 on the last bf16 state
    float logit0 = 0.0f, logit1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 w = ld2(prm.out_w + c2, j);
      logit0 += bf16_round(R[4 * j]) * w.x + bf16_round(R[4 * j + 1]) * w.y;
      logit1 += bf16_round(R[4 * j + 2]) * w.x + bf16_round(R[4 * j + 3]) * w.y;
      pace(j);
    }
    logit0 = quad_sum(logit0) + prm.mlp_b[NLIN - 1][0];
    logit1 = quad_sum(logit1) + prm.mlp_b[NLIN - 1][0];
    PROF(20);
    if (t == 0) {
      if (row0 + ra < P) out[soff + row0 + ra] = logit0;
      if (row0 + ra + 8 < P) out[soff + row0 + ra + 8] = logit1;
    }
  }
}

__global__ void __launch_bounds__(NTHREAD, 1)
    implicit_decoder_kernel(const __grid_constant__ DecoderParams prm, const float* __restrict__ pts,
                            float* __restrict__ out, int P, int L, float2* scratch, int ntiles, int nitems) {
  const uint32_t bars = ((smem_u32(smem_raw) + 1023) & ~1023u) + OFF_BAR;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(bars + s * 8, 1);                      // full: the producer's expect_tx
      mbar_init(bars + (NSTAGE + s) * 8, NCONS * 4);   // empty: one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NCONS * 128) {
    // the producer warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS * 128) produce(prm, ntiles, nitems);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume(prm, pts, out, P, L, scratch, ntiles, nitems);
  }
}

}  // namespace

#ifdef ZS_PROFILE
// The phase counters of a -DZS_PROFILE build (profile_k1.py): cycles summed
// over the first thread of every consumer warpgroup, one slot per phase.
extern "C" int zs_prof_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, zs_prof, sizeof(zs_prof));
}
extern "C" int zs_prof_reset() {
  const unsigned long long zero[24] = {};
  return (int)cudaMemcpyToSymbol(zs_prof, zero, sizeof(zs_prof));
}
#endif

// Logits for B samples of P points each (pts [B][P][3] fp32 -> out [B][P]
// fp32), sample b against its own packed caches (prm->caches holds B blocks
// of CACHE_BYTES) of L <= 208 latent keys. The persistent grid walks B x
// ntiles work items; a point's logit does not depend on the item it lands
// in, so each sample's logits equal those of a launch of that sample alone.
// `scratch` holds n_slots * 2 * 64 * 256 floats (the parked residuals; the
// grid has at most n_slots blocks). Launches on `stream`; returns the
// launch's cudaError_t (0 = success).
extern "C" int zs_implicit_decode_batched(const DecoderParams* prm, const float* pts, float* out, int B, int P,
                                          int L, float* scratch, int n_slots, void* stream) {
  if (L < 1 || L > MAX_LP || n_slots < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (P <= 0 || B == 0) return 0;
  const long long ntiles = (P + TILE_P - 1) / TILE_P, nitems = ntiles * B;
  if (nitems > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(implicit_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = nitems < n_slots ? (int)nitems : n_slots;
  implicit_decoder_kernel<<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      *prm, pts, out, P, L, reinterpret_cast<float2*>(scratch), (int)ntiles, (int)nitems);
  return (int)cudaGetLastError();
}

// One sample: the B = 1 case (pts [P][3] -> out [P]).
extern "C" int zs_implicit_decode(const DecoderParams* prm, const float* pts, float* out, int P, int L,
                                  float* scratch, int n_slots, void* stream) {
  return zs_implicit_decode_batched(prm, pts, out, 1, P, L, scratch, n_slots, stream);
}

