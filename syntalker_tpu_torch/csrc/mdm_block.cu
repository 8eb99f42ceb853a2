// Hand-written Hopper (sm_90a) kernels for the MDM denoiser's hot path.
//
// Replaces two TPU kernels of syntalker_tpu/ops/mdm_pallas.py:
//   * _block_kernel (built by fused_block_stack): the 8-layer pre-LN
//     transformer stack on (B, 32, 512);
//   * _ddim_window_kernel (built by make_fused_ddim_window): the whole
//     50-step eta=0 DDIM loop of one window, i.e. the input projections,
//     RoPE, the block stack, the output projection and x <- a*x + b*x0.
// A TPU grid runs its steps in order and carries the activation in VMEM
// from one step to the next; Hopper blocks carry nothing between launches.
// So the DDIM state and the activation live in device memory, and the host
// (syntalker_tpu_torch/ops/mdm_cuda.py) records the launches of one window
// (or one pass of the stack) into a CUDA graph once and replays it:
//   mdm_gemm            bf16 x bf16 -> f32 GEMM on wgmma, operands in
//                       swizzled shared memory, streamed by TMA through a
//                       4-stage mbarrier ring; fused epilogues from the
//                       accumulator registers (bias; bias -> bf16;
//                       bias + erf-GELU -> bf16; bias + residual add into
//                       the f32 stream; bias + the DDIM update)
//   mdm_layernorm_bf16  LayerNorm (eps 1e-6) in f32, written as bf16
//   mdm_attention       attention of one (sample, head) and a slice of its
//                       query rows, in f32 shared memory
//   mdm_prologue        the style-row broadcast, the audio/word slab, the
//                       x_emb slab, the input_process2 bias, RoPE and the
//                       first layer's LayerNorm
// Numerics follow the TPU kernel: weights and matmul inputs are bf16,
// products accumulate in f32, LayerNorm, softmax, the residual stream and
// the DDIM state stay f32. GELU is the exact erf form and RoPE the
// elementwise half-swap in f32 (the TPU kernel used tanh and a +-1
// permutation matmul only because Mosaic lacks erf and lane regrouping).
//
// What bounds it on the H100. One pass of the stack holds B * 1.09 GFLOP
// against 33.5 MB of bf16 weights, so from B ~ 9 up the arithmetic is above
// the bf16 ridge (~295 FLOP/byte). But at the serving shape (B = 8, 256
// rows) one GEMM is 0.13-0.4 GFLOP, under a microsecond of tensor-core
// time: what a launch costs there is latency (the launch, the first TMA
// round trip, the dependent k-blocks, the epilogue's round trip to L2), and
// a step is ~59 launches of 2.5-6 us. At B = 256 (8,192 rows) the f32
// epilogues and the f32 qkv buffer move more bytes than the multiplies take
// time. The design answers each:
//   * tiles are picked per shape (pick_tile): 64 x 32 at 256 rows, so
//     that 64-192 blocks start, 128 x 128 with two consumer warpgroups at
//     8,192 rows;
//   * a producer warp keeps four k-blocks of TMA loads in flight while the
//     consumer warpgroups run wgmma and wait only for the group before
//     the one just started;
//   * epilogues run from the accumulator registers: a warp turns its 16
//     rows over through shared memory once, then reads, updates and writes
//     whole 128-byte lines with 16-byte accesses, and the in-place ones
//     start all their loads before their first store;
//   * attention splits each (sample, head) over query rows to start 128
//     blocks at B = 8, loads K, V and q with 16-byte loads, and at large B
//     carries four query rows a thread to spare shared-memory bandwidth;
//   * LayerNorm holds a row in registers (one 16-byte load pass);
//   * nothing in a launch touches the stream but the kernel: the attributes
//     are set once in mdm_init, and a TMA descriptor is encoded on the host
//     (no device work) and travels as a kernel argument, so a whole window
//     can be captured into one CUDA graph, which then holds its descriptors.
//
// The A operand is bf16 and comes through TMA like the weights. Where a
// kernel of the path reads an f32 tensor that another GEMM wrote, that
// GEMM's epilogue also writes the bf16 copy: EPI_DDIM for the DDIM state
// that input_process reads, EPI_BIAS_RESIDUAL for the last layer's stream
// that the output projection reads. LayerNorm is a launch of its own: folded
// into the GEMM that reads it (the block normalises a 64 x 512 f32 row panel
// into shared memory, only B streams), every column tile of a row panel
// read and normalised the panel again, 24 times for qkv, and took about
// twice the time at 256 rows and 2.7 times at 8,192 (PERF.md has both).

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;      // k-block: 64 bf16 = one 128-byte swizzled row
constexpr int STAGES = 4;   // depth of the TMA ring
constexpr int MAX_SMEM = 227 * 1024;
constexpr int ATTN_MAX_SMEM = 160 * 1024;

enum Epilogue {
  EPI_STORE = 0,           // out_f = acc + bias
  EPI_BIAS_BF16 = 1,       // out_h = bf16(acc + bias)
  EPI_BIAS_GELU_BF16 = 2,  // out_h = bf16(gelu(acc + bias))
  EPI_BIAS_RESIDUAL = 3,   // out_f = (out_f + acc) + bias; out_h = bf16(out_f) if given
  EPI_DDIM = 4,            // out_f = ca * out_f + cb * (acc + bias); out_h = bf16(out_f) if given
};

struct GemmArgs {
  const float* bias;
  float* out_f;
  bf16* out_h;
  int M, N, K, epi;
  float ca, cb;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// PTX: mbarrier, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2D tensor map into shared memory; c0 is the inner coordinate.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor: address, leading and stride byte offsets
// in 16-byte units, swizzle mode in the top bits (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(swizzle) << 62);
}

// D[64, BN] (+)= A[64, 16] * B[16, BN]: A K-major, B N-major (the weights
// are row-major (K, N), so the transpose flag of B is set).
template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// ---------------------------------------------------------------------------
// GEMM

// Shared-memory geometry of one instantiation. The A tile of a k-block is
// BM rows of 128 bytes, 128-byte swizzled (what TMA writes for a 64-wide
// bf16 box). A B stage is 64 k-rows of
// BN bf16: one 64-byte-swizzled box for BN = 32, one 128-byte-swizzled box
// for BN = 64, two of them side by side for BN = 128.
template <int WG, int BN>
struct Tile {
  static constexpr int BM = 64 * WG;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int A_BLOCK = BM * 128;        // bytes of one k-block of A
  static constexpr int B_BOX_COLS = BN < 64 ? BN : 64;
  static constexpr int B_ROW = B_BOX_COLS * 2;    // bytes of one k-row of a box
  static constexpr int B_BOX = BK * B_ROW;
  static constexpr int B_STAGE = B_BOX * (BN / B_BOX_COLS);
  static constexpr int B_SWIZZLE = BN < 64 ? 2 : 1;
};

template <int WG, int BN>
constexpr size_t gemm_smem() {
  using T = Tile<WG, BN>;
  return 1024 + (size_t)STAGES * (T::A_BLOCK + T::B_STAGE) + 2 * STAGES * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The epilogue of one warpgroup's 64 x BN accumulators. Thread t of the
// warpgroup holds rows (t/32)*16 + (t%32)/4 and +8, and for every 8 columns
// the pair at (t%4)*2: stored from there, one instruction of a warp would
// touch 8 rows with 32 bytes each. So each warp first turns its own 16 rows
// over through shared memory (`stage`, rows 8 floats apart from BN so that
// the 8-byte writes of a half-warp miss each other's banks; only the warp
// itself reads them back, so a warp-level sync is enough) and then owns
// 16 bytes of consecutive columns a lane, whole 128-byte lines a row.
// The in-place epilogues start all their loads before their first store:
// the compiler must assume the two alias, and written as load, add, store
// per vector a thread would wait out a round trip to L2 for each.
template <int BN>
__device__ __forceinline__ void epilogue(const float (&d)[BN / 2], const GemmArgs& g, float* stage,
                                         int row0, int n0) {
  constexpr int LD = BN + 8, LANES = BN / 4, ROWS = 32 / LANES, STEPS = 16 / ROWS;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  float* mine = stage + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(mine + (lane / 4 + 8 * h) * LD + 8 * j + (lane % 4) * 2) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  __syncwarp();

  const int c = n0 + (lane % LANES) * 4, r_lane = lane / LANES;
  const bool in_place = g.epi == EPI_BIAS_RESIDUAL || g.epi == EPI_DDIM;
  const bool col_ok = c < g.N;  // N is a multiple of 8 (checked on the host): no vector straddles the edge
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g.bias && col_ok) bv = *reinterpret_cast<const float4*>(g.bias + c);
  float4 old[STEPS];
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int r = row0 + warp * 16 + i * ROWS + r_lane;
    old[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in_place && col_ok && r < g.M) old[i] = *reinterpret_cast<const float4*>(g.out_f + (size_t)r * g.N + c);
  }
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int rl = i * ROWS + r_lane, r = row0 + warp * 16 + rl;
    if (!col_ok || r >= g.M) continue;
    const float4 a = *reinterpret_cast<const float4*>(mine + rl * LD + (lane % LANES) * 4);
    const float4 v = make_float4(a.x + bv.x, a.y + bv.y, a.z + bv.z, a.w + bv.w);
    const float4 x = old[i];
    const size_t o = (size_t)r * g.N + c;
    float4 y = v;
    switch (g.epi) {
      case EPI_STORE:
      case EPI_BIAS_BF16:
        break;
      case EPI_BIAS_GELU_BF16:
        y.x = v.x * 0.5f * (1.0f + erff(v.x * 0.70710678118654752f));
        y.y = v.y * 0.5f * (1.0f + erff(v.y * 0.70710678118654752f));
        y.z = v.z * 0.5f * (1.0f + erff(v.z * 0.70710678118654752f));
        y.w = v.w * 0.5f * (1.0f + erff(v.w * 0.70710678118654752f));
        break;
      case EPI_BIAS_RESIDUAL:  // (x + acc) + bias, as the plain version adds them
        y = make_float4((x.x + a.x) + bv.x, (x.y + a.y) + bv.y, (x.z + a.z) + bv.z, (x.w + a.w) + bv.w);
        break;
      case EPI_DDIM:
        y = make_float4(g.ca * x.x + g.cb * v.x, g.ca * x.y + g.cb * v.y, g.ca * x.z + g.cb * v.z,
                        g.ca * x.w + g.cb * v.w);
        break;
    }
    const bool to_h = g.epi == EPI_BIAS_BF16 || g.epi == EPI_BIAS_GELU_BF16;
    if (!to_h) *reinterpret_cast<float4*>(g.out_f + o) = y;
    if (to_h || (in_place && g.out_h))
      *reinterpret_cast<uint2*>(g.out_h + o) = make_uint2(pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
  }
}

// C[M, N] = A[M, K] @ B[K, N], row-major, one BM x BN tile a block. Warps
// 0 .. 4*WG-1 are WG consumer warpgroups of 64 rows each; the last warp is
// the producer. full[s] flips when stage s has landed (TMA transaction
// bytes), empty[s] when every consumer warpgroup is done reading it. Edges:
// TMA zero-fills what lies outside the tensors, the epilogue masks rows and
// columns, so any M, any K and N that are multiples of 8 work.
template <int WG, int BN>
__global__ void __launch_bounds__(Tile<WG, BN>::THREADS)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const GemmArgs g) {
  using T = Tile<WG, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nkb = (g.K + BK - 1) / BK;
  uint8_t* a_base = smem;
  uint8_t* b_base = a_base + STAGES * T::A_BLOCK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(b_base + STAGES * T::B_STAGE);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + STAGES);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= T::CONSUMERS) {
    // producer: one lane keeps up to STAGES k-blocks in flight
    if (threadIdx.x == T::CONSUMERS) {
      constexpr uint32_t bytes = T::A_BLOCK + T::B_STAGE;
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty + 8 * s, ((kb / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        tma_load_2d(smem_u32(a_base + s * T::A_BLOCK), &map_a, full + 8 * s, kb * BK, m0);
#pragma unroll
        for (int box = 0; box < BN / T::B_BOX_COLS; ++box)
          tma_load_2d(smem_u32(b_base + s * T::B_STAGE + box * T::B_BOX), &map_b, full + 8 * s,
                      n0 + box * T::B_BOX_COLS, kb * BK);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(full + 8 * s, (kb / STAGES) & 1);
    const uint32_t a_tile = smem_u32(a_base + s * T::A_BLOCK) + wg * 64 * 128;
    const uint32_t b_tile = smem_u32(b_base + s * T::B_STAGE);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 k-columns further is 32 bytes inside the swizzled row; 8 rows are 1024 bytes apart.
      // B: 16 k-rows further is 16 rows of the box; 8 k-rows are 8 * B_ROW apart, the next 64
      // columns one box apart.
      const uint64_t da = smem_desc(a_tile + kk * 32, 16, 1024, 1);
      const uint64_t db = smem_desc(b_tile + kk * 16 * T::B_ROW, T::B_BOX, 8 * T::B_ROW, T::B_SWIZZLE);
      Wgmma<BN>::mma(acc, da, db, (kb | kk) != 0);
    }
    wgmma_commit();
    // keep this group in flight, retire the one before and hand its stage back
    wgmma_wait<1>();
    if (kb > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((kb - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // The ring is free now: every load has landed and every wgmma of this warpgroup has retired.
  // With two warpgroups the other one may still read the stages that this one's tile goes over.
  if (WG > 1) asm volatile("bar.sync 1, %0;" ::"n"(T::CONSUMERS) : "memory");
  float* stage = reinterpret_cast<float*>(a_base) + wg * 64 * (BN + 8);
  epilogue<BN>(acc, g, stage, m0 + wg * 64, n0);
}

// ---------------------------------------------------------------------------
// the other kernels

// One warp per row, the row in registers (D <= 1024, a multiple of 4):
// 16-byte loads, two-pass mean / variance in f32, output rounded to bf16.
__global__ void __launch_bounds__(256)
layernorm_bf16_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, bf16* __restrict__ out, int rows, int D,
                      float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  const int d4 = D / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * D);
  float4 v[8];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = lane + 32 * j < d4 ? xr[lane + 32 * j] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
  }
  const float mean = warp_sum(s) / D;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (lane + 32 * j < d4) {
      const float a = v[j].x - mean, b = v[j].y - mean, c = v[j].z - mean, d = v[j].w - mean;
      sq += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float inv = 1.0f / sqrtf(warp_sum(sq) / D + eps);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = lane + 32 * j;
    if (i >= d4) continue;
    const float4 sc = reinterpret_cast<const float4*>(scale)[i], sh = reinterpret_cast<const float4*>(shift)[i];
    *reinterpret_cast<uint2*>(out + (size_t)row * D + 4 * i) =
        make_uint2(pack_bf16((v[j].x - mean) * inv * sc.x + sh.x, (v[j].y - mean) * inv * sc.y + sh.y),
                   pack_bf16((v[j].z - mean) * inv * sc.z + sh.z, (v[j].w - mean) * inv * sc.w + sh.w));
  }
}

// One block per (sample, head) and slice of R query rows. qkv is (B*T, 3D)
// f32 with column blocks [q | k | v], each head-major; out is (B*T, D) bf16.
// Shared memory holds K (rows padded by 4 floats, so that the 16-byte reads
// of 8 lanes on 8 rows fall on different banks), V, the slice's q rows
// (scaled) and its scores. Shared-memory bandwidth bounds it: a K or V read
// of 32 lanes on 32 addresses costs four times a q or p read that all lanes
// share. So a thread carries RT query rows against one K row (scores) or one
// V column group (output), and reads each K and V vector once for the RT of
// them. RT = 1 where a block has only 8 rows, to keep all its threads busy.
// hd is a multiple of 4; the q and score buffers hold R rounded up to RT.
template <int RT>
__global__ void __launch_bounds__(256)
attention_kernel(const float* __restrict__ qkv, bf16* __restrict__ out, int T, int D, int H,
                 float scale, int R) {
  extern __shared__ float attn_smem[];
  const int hd = D / H, hd4 = hd / 4, ks = hd + 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, i0 = blockIdx.y * R;
  const int rows = min(R, T - i0), groups = (rows + RT - 1) / RT, rpad = (R + RT - 1) / RT * RT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, nwarps = blockDim.x / 32;
  float* Ks = attn_smem;
  float* Vs = Ks + T * ks;
  float* Qs = Vs + T * hd;
  float* Ss = Qs + rpad * hd;
  const float* base = qkv + (size_t)b * T * 3 * D + h * hd;
  for (int e = tid; e < T * hd4; e += blockDim.x) {
    const int t = e / hd4, d = (e % hd4) * 4;
    const float* row = base + (size_t)t * 3 * D + d;
    *reinterpret_cast<float4*>(Ks + t * ks + d) = *reinterpret_cast<const float4*>(row + D);
    *reinterpret_cast<float4*>(Vs + t * hd + d) = *reinterpret_cast<const float4*>(row + 2 * D);
  }
  for (int e = tid; e < rpad * hd4; e += blockDim.x) {
    const int i = e / hd4, d = (e % hd4) * 4;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < rows) q = *reinterpret_cast<const float4*>(base + (size_t)(i0 + i) * 3 * D + d);
    q.x *= scale, q.y *= scale, q.z *= scale, q.w *= scale;
    *reinterpret_cast<float4*>(Qs + i * hd + d) = q;
  }
  __syncthreads();
  for (int e = tid; e < groups * T; e += blockDim.x) {
    const int i = (e / T) * RT, j = e % T;
    const float4* k = reinterpret_cast<const float4*>(Ks + j * ks);
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
    for (int d = 0; d < hd4; ++d) {
      const float4 c = k[d];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(Qs + (i + r) * hd + 4 * d);
        acc[r] += a.x * c.x;
        acc[r] += a.y * c.y;
        acc[r] += a.z * c.z;
        acc[r] += a.w * c.w;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) Ss[(i + r) * T + j] = acc[r];  // rows past `rows` are zero q rows
  }
  __syncthreads();
  for (int i = warp; i < rows; i += nwarps) {
    float m = -INFINITY;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, Ss[i * T + j]);
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < T; j += 32) {
      const float p = expf(Ss[i * T + j] - m);
      Ss[i * T + j] = p;
      s += p;
    }
    s = warp_sum(s);
    for (int j = lane; j < T; j += 32) Ss[i * T + j] /= s;
  }
  __syncthreads();
  for (int e = tid; e < groups * hd4; e += blockDim.x) {
    const int i = (e / hd4) * RT, d = (e % hd4) * 4;
    float4 acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < T; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(Vs + j * hd + d);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float p = Ss[(i + r) * T + j];
        acc[r].x += p * v.x, acc[r].y += p * v.y, acc[r].z += p * v.z, acc[r].w += p * v.w;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (i + r < rows)
        *reinterpret_cast<uint2*>(out + (size_t)(b * T + i0 + i + r) * D + h * hd + d) =
            make_uint2(pack_bf16(acc[r].x, acc[r].y), pack_bf16(acc[r].z, acc[r].w));
    }
  }
}

constexpr int ATTN_RT = 4;  // rows a thread carries where a block has 16 query rows or more

size_t attention_smem(int T, int hd, int R) {
  const int rpad = (R + ATTN_RT - 1) / ATTN_RT * ATTN_RT;
  return (size_t)(T * (hd + 4) + T * hd + rpad * hd + rpad * T) * sizeof(float);
}

// Sum over the block (256 threads); `part` is 8 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with `part`
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < 8; ++w) s += part[w];
  return s;
}

// One block per token row of K1's step prologue:
//   h = style_p[sample] + xe_p[row] + at_p[row] + bias
//   act[row] = h * cos[t] + rot(h) * sin[t]  (half-swap per rope sub-head)
// The block holds the whole row, so it also writes the first layer's
// LayerNorm of it as bf16 (two-pass, f32) if act_ln is given. D <= 1024.
__global__ void __launch_bounds__(256)
prologue_kernel(const float* __restrict__ style_p, const float* __restrict__ xe_p,
                const float* __restrict__ at_p, const float* __restrict__ bias,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                float* __restrict__ act, const float* __restrict__ ln_scale,
                const float* __restrict__ ln_shift, bf16* __restrict__ act_ln, float eps, int T,
                int D, int rope_heads) {
  __shared__ float part[8];
  const int row = blockIdx.x, b = row / T, t = row % T;
  const int hd = D / rope_heads, half = hd / 2;
  const float* sp = style_p + (size_t)b * D;
  const float* xr = xe_p + (size_t)row * D;
  const float* ar = at_p + (size_t)row * D;
  float v[4];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + 256 * i;
    v[i] = 0.0f;
    if (c >= D) continue;
    const int cc = c % hd;
    const int pc = cc < half ? c + half : c - half;
    const float hv = sp[c] + xr[c] + ar[c] + bias[c];
    const float hp = sp[pc] + xr[pc] + ar[pc] + bias[pc];
    const float rot = cc < half ? -hp : hp;
    v[i] = hv * cos_t[t * hd + cc] + rot * sin_t[t * hd + cc];
    act[(size_t)row * D + c] = v[i];
    s += v[i];
  }
  if (!act_ln) return;  // block-uniform
  const float mean = block_sum(s, part) / D;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = v[i] - mean;
    if (threadIdx.x + 256 * i < D) sq += d * d;
  }
  const float inv = 1.0f / sqrtf(block_sum(sq, part) / D + eps);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + 256 * i;
    if (c < D) act_ln[(size_t)row * D + c] = __float2bfloat16((v[i] - mean) * inv * ln_scale[c] + ln_shift[c]);
  }
}

// ---------------------------------------------------------------------------
// host side: TMA descriptors, tile choice, launches

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links without -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The descriptor of a row-major bf16 (rows, cols) tensor cut into
// (box_rows, box_cols) boxes. Encoding is host work only (no stream, no
// allocation), so it is legal under stream capture; the kernel takes the
// descriptor by value, so a captured launch keeps its own copy. Returns
// false if the encoder refuses.
bool tensor_map(CUtensorMap* out, const void* ptr, int rows, int cols, int box_rows, int box_cols,
                int swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WG, int BN>
cudaError_t launch_gemm(const void* a, const void* b, const GemmArgs& g, cudaStream_t stream) {
  using T = Tile<WG, BN>;
  static_assert(gemm_smem<WG, BN>() <= MAX_SMEM, "the ring does not fit in shared memory");
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, g.M, g.K, T::BM, BK, 1)) return cudaErrorInvalidValue;
  if (!tensor_map(&map_b, b, g.K, g.N, BK, T::B_BOX_COLS, T::B_SWIZZLE)) return cudaErrorInvalidValue;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + T::BM - 1) / T::BM);
  gemm_kernel<WG, BN><<<grid, T::THREADS, gemm_smem<WG, BN>(), stream>>>(map_a, map_b, g);
  return cudaGetLastError();
}

template <int WG, int BN>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_kernel<WG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              MAX_SMEM);
}

// Tile for a shape: X(consumer warpgroups, columns) for each that exists.
// With thousands of rows: 128 x 128, two consumer warpgroups (the widest
// wgmma this file has, which spares shared-memory bandwidth, and half the A
// traffic of a 64-row tile). At the service's 256 rows the widest of
// 128 / 64 / 32 columns that still starts a block of 64 rows for each of the
// 132 SMs, else the narrowest (which measures fastest for all six shapes of
// the path at 256 rows).
#define FOR_EACH_TILE(X) X(1, 32) X(1, 64) X(1, 128) X(2, 128)

void pick_tile(int M, int N, int* wg, int* bn) {
  if (N % 128 == 0 && ((M + 127) / 128) * (N / 128) >= 132) {
    *wg = 2, *bn = 128;
    return;
  }
  const int row_tiles = (M + 63) / 64;
  *wg = 1, *bn = 32;
  for (int c = 128; c > 32; c /= 2) {
    if ((c < 128 || N % 128 == 0) && row_tiles * ((N + c - 1) / c) >= 132) {
      *bn = c;
      return;
    }
  }
}

}  // namespace

extern "C" {

// Once per process, outside any stream capture: the shared-memory limits of
// the kernels and the descriptor encoder (cuTensorMapEncodeTiled).
int mdm_init(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaErrorInvalidDevice;
#define ALLOW(WG, BN) if (e == cudaSuccess) e = allow_smem<WG, BN>();
  FOR_EACH_TILE(ALLOW)
#undef ALLOW
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, ATTN_MAX_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_kernel<ATTN_RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, ATTN_MAX_SMEM);
  if (e == cudaSuccess && !encode_tiled()) e = cudaErrorSymbolNotFound;
  return (int)e;
}

int mdm_layernorm_bf16(const float* x, const float* scale, const float* shift, void* out,
                       int rows, int D, float eps, void* stream) {
  if (D % 4 || D > 1024) return (int)cudaErrorInvalidValue;
  const int threads = 256, rows_per_block = threads / 32;
  layernorm_bf16_kernel<<<(rows + rows_per_block - 1) / rows_per_block, threads, 0,
                          (cudaStream_t)stream>>>(x, scale, shift, (bf16*)out, rows, D, eps);
  return (int)cudaGetLastError();
}

// out_f (f32) or out_h (bf16) [M, N] = epilogue(a (bf16) [M, K] @ b (bf16) [K, N]); N and K are
// multiples of 8 (TMA rows are multiples of 16 bytes).
int mdm_gemm(const void* a, const void* b, int M, int N, int K, int epi, const float* bias,
             float* out_f, void* out_h, float ca, float cb, void* stream) {
  if (M < 1 || N % 8 || K % 8) return (int)cudaErrorInvalidValue;
  GemmArgs g;
  g.bias = bias, g.out_f = out_f, g.out_h = (bf16*)out_h;
  g.M = M, g.N = N, g.K = K, g.epi = epi;
  g.ca = ca, g.cb = cb;
  int wg, bn;
  pick_tile(M, N, &wg, &bn);
#define TRY(WG, BN) \
  if (wg == WG && bn == BN) return (int)launch_gemm<WG, BN>(a, b, g, (cudaStream_t)stream);
  FOR_EACH_TILE(TRY)
#undef TRY
  return (int)cudaErrorInvalidValue;
}

// A block takes 8 query rows while that keeps the grid under two waves of
// the card, else the whole sequence.
int mdm_attention(const float* qkv, void* out, int B, int T, int D, int H, float scale,
                  void* stream) {
  const int hd = D / H;
  if (hd % 4 || D % H) return (int)cudaErrorInvalidValue;
  const int R = (long long)B * H * ((T + 7) / 8) <= 2 * 132 ? min(8, T) : T;
  const size_t smem = attention_smem(T, hd, R);
  if (smem > ATTN_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (T + R - 1) / R);
  if (R >= 4 * ATTN_RT) {
    attention_kernel<ATTN_RT><<<grid, 256, smem, (cudaStream_t)stream>>>(qkv, (bf16*)out, T, D, H, scale, R);
  } else {
    attention_kernel<1><<<grid, 256, smem, (cudaStream_t)stream>>>(qkv, (bf16*)out, T, D, H, scale, R);
  }
  return (int)cudaGetLastError();
}

// ln_scale, ln_shift, act_ln: the first layer's LayerNorm of act as bf16, or null.
int mdm_prologue(const float* style_p, const float* xe_p, const float* at_p, const float* bias,
                 const float* cos_t, const float* sin_t, float* act, const float* ln_scale,
                 const float* ln_shift, void* act_ln, float eps, int B, int T, int D,
                 int rope_heads, void* stream) {
  if (D > 1024) return (int)cudaErrorInvalidValue;
  prologue_kernel<<<B * T, 256, 0, (cudaStream_t)stream>>>(
      style_p, xe_p, at_p, bias, cos_t, sin_t, act, ln_scale, ln_shift, (bf16*)act_ln, eps, T, D,
      rope_heads);
  return (int)cudaGetLastError();
}

}  // extern "C"
