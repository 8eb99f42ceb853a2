// Hand-written Hopper (sm_90a) kernels for the residual-VQ snap.
//
// Replaces _rvq_encode_kernel (built by rvq_encode_fused) of
// syntalker_tpu/ops/quantize_pallas.py. For each of Q residual layers:
//   dist = |r|^2 - 2 r.C_q^T + |C_q|^2   (full f32)
//   idx  = argmin dist                   (lowest index wins ties)
//   code = C_q[idx]                      (direct row read)
//   out += code; r -= code
// and returns the summed codes (N, D) f32 and the indices (N, Q) int32.
//
// What bounds it on the H100: N*Q*K*D multiply-adds (2*N*6*512*512 FLOP
// per body part) in FP32 on the CUDA cores, because the argmin must not
// flip: TF32 or bf16 tensor cores would move distances by more than the gap
// between the two nearest codes. Its bytes are small (6 MB of codebooks
// plus the rows), so at 67 TFLOP/s FP32 the operations are the bound. At a
// few thousand rows a layer is too little work to fill the card for long,
// and each launch's start and drain weigh as much as its arithmetic.
//
// Design: one call is 1 + 2Q launches on the caller's stream, all made here.
//  - rvq_norms_kernel: |c|^2 of all Q*K codes and |x|^2 of the rows, once,
//    one warp a vector; it empties every row's argmin key.
//  - rvq_distance_kernel, per layer: a register-tiled FP32 GEMM of the
//    residual rows against the codebook, split over both: one block of 64
//    threads takes 32 rows x 32 codes, so the serve flush's 928 rows make
//    464 blocks on 132 SMs. D streams in 32-wide slices through a 3-stage
//    cp.async ring, so the next slices load while slice s computes. Shared
//    memory keeps each row and code D-contiguous, padded to 36 floats, so
//    eight consecutive rows or codes sit in eight different 16-byte bank
//    groups. A thread owns 4 rows x 4 codes (rows ty + i*8, codes tx + j*8);
//    per 4 d it reads 8 float4s for 64 FMAs, 8 FMAs a shared load. Each
//    distance is one sequential FMA chain over d, then r2 - 2*cross + c2 as
//    the reference writes it.
//  - The argmin across blocks: each block reduces its codes per row in
//    registers and with warp shuffles to one 64-bit key (the distance in an
//    order-preserving high word, negatives included, the code index in the
//    low word) and takes one atomicMin per row into an (N,) scratch. The
//    result does not depend on the order of blocks, and the lowest index
//    wins exact ties.
//  - rvq_apply_kernel, per layer: one warp a row takes and empties the key
//    and writes idx[:, q]; below the last layer it writes r = r - code and
//    the next layer's |r|^2, and at the last layer it sums the chosen codes
//    into out, so out is written once. It is a launch of its own, so no
//    distance block reads a residual row that another block of the same
//    launch writes. Layer 0 reads x and writes the residual scratch; x is
//    never written.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32, BN = 32;  // rows and codes a block
constexpr int TM = 4, TN = 4;    // rows and codes a thread
constexpr int TX = BN / TN, TY = BM / TM, DIST_THREADS = TX * TY;
constexpr int STAGES = 3;        // slices in flight in the cp.async ring
constexpr int BK = 32;           // depth of one D slice
constexpr int LD = BK + 4;       // padded shared row: 9 units of 16 bytes
constexpr unsigned long long EMPTY = ~0ull;
constexpr int NORM_THREADS = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// |v|^2 by one warp: lane-strided float4s, then a shuffle tree, in a fixed order.
__device__ __forceinline__ float sum_squares(const float* v, int D, int lane) {
  float s = 0.0f;
  for (int d = lane * 4; d < D; d += 128) {
    const float4 a = ld4(v + d);
    s = fmaf(a.x, a.x, s);
    s = fmaf(a.y, a.y, s);
    s = fmaf(a.z, a.z, s);
    s = fmaf(a.w, a.w, s);
  }
  return warp_sum(s);
}

// The smallest key is the smallest distance and, among equal distances,
// the lowest code index. The high word orders like the float for either
// sign; -0 is taken to +0 first, so equal distances give equal high words.
__device__ __forceinline__ unsigned long long pack_key(float dist, int k) {
  unsigned u = __float_as_uint(dist + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)k;
}

__global__ void __launch_bounds__(NORM_THREADS)
rvq_norms_kernel(const float* __restrict__ x, const float* __restrict__ codebooks, float* __restrict__ r2,
                 float* __restrict__ c2, unsigned long long* __restrict__ keys, int N, int QK, int D) {
  const int w = (blockIdx.x * NORM_THREADS + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w < QK) {
    const float s = sum_squares(codebooks + (size_t)w * D, D, lane);
    if (lane == 0) c2[w] = s;
  } else if (w < QK + N) {
    const int row = w - QK;
    const float s = sum_squares(x + (size_t)row * D, D, lane);
    if (lane == 0) {
      r2[row] = s;
      keys[row] = EMPTY;
    }
  }
}

// One warp a row: below the last layer r = r - code and |r|^2; at the
// last layer out = C_0[i_0] + C_1[i_1] + ..., added in layer order from
// zero as the reference adds them. res_in is x at layer 0 and res after
// it, updated in place: neither pointer is __restrict__.
__global__ void __launch_bounds__(NORM_THREADS)
rvq_apply_kernel(const float* res_in, const float* __restrict__ codebooks, float* res, float* __restrict__ out,
                 int* __restrict__ idx, float* __restrict__ r2, unsigned long long* __restrict__ keys, int N, int Q,
                 int K, int q, int D) {
  const int row = (blockIdx.x * NORM_THREADS + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= N) return;
  const int k = (int)(unsigned)keys[row];
  __syncwarp();  // every lane has read the key before it is emptied
  if (lane == 0) {
    keys[row] = EMPTY;
    idx[(size_t)row * Q + q] = k;
  }
  const size_t base = (size_t)row * D;
  if (q < Q - 1) {
    const float* code = codebooks + ((size_t)q * K + k) * D;
    float s = 0.0f;
    for (int d = lane * 4; d < D; d += 128) {
      const float4 c = ld4(code + d), r = ld4(res_in + base + d);
      const float4 n = make_float4(r.x - c.x, r.y - c.y, r.z - c.z, r.w - c.w);
      *reinterpret_cast<float4*>(res + base + d) = n;
      s = fmaf(n.x, n.x, s);
      s = fmaf(n.y, n.y, s);
      s = fmaf(n.z, n.z, s);
      s = fmaf(n.w, n.w, s);
    }
    s = warp_sum(s);
    if (lane == 0) r2[row] = s;
    return;
  }
  for (int d = lane * 4; d < D; d += 128) {
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p = 0; p < Q; ++p) {
      const int kp = p == q ? k : idx[(size_t)row * Q + p];
      const float4 c = ld4(codebooks + ((size_t)p * K + kp) * D + d);
      o = make_float4(o.x + c.x, o.y + c.y, o.z + c.z, o.w + c.w);
    }
    *reinterpret_cast<float4*>(out + base + d) = o;
  }
}

__global__ void __launch_bounds__(DIST_THREADS)
rvq_distance_kernel(const float* __restrict__ res, const float* __restrict__ cb, const float* __restrict__ r2,
                    const float* __restrict__ c2, unsigned long long* __restrict__ keys, int N, int D) {
  constexpr int STAGE = (BM + BN) * LD;
  static_assert(DIST_THREADS % 32 == 0 && 32 % TX == 0, "a row's threads lie in one warp");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int code0 = blockIdx.x * BN, row0 = blockIdx.y * BM, slices = D / BK;

  auto load = [&](int slice, int stage) {
    float* rs = smem + stage * STAGE;
    float* cs = rs + BM * LD;
    const int d0 = slice * BK;
    for (int e = tid; e < BM * BK / 4; e += DIST_THREADS) {
      const int r = e / (BK / 4), c = e % (BK / 4), gr = row0 + r;
      cp_async16(rs + r * LD + c * 4, res + (size_t)min(gr, N - 1) * D + d0 + c * 4, gr < N ? 16 : 0);
    }
    for (int e = tid; e < BN * BK / 4; e += DIST_THREADS) {
      const int r = e / (BK / 4), c = e % (BK / 4);
      cp_async16(cs + r * LD + c * 4, cb + (size_t)(code0 + r) * D + d0 + c * 4, 16);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice s have landed
    __syncthreads();              // everyone's have, and slice s-1's stage is free
    if (s + STAGES - 1 < slices) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* rs = smem + (s % STAGES) * STAGE;
    const float* cs = rs + BM * LD;
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(rs + (ty + i * TY) * LD + k4 * 4);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(cs + (tx + j * TX) * LD + k4 * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + i * TY;
    const float rr = r2[min(row, N - 1)];
    unsigned long long best = EMPTY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = code0 + tx + j * TX;
      const float dist = rr - 2.0f * acc[i][j] + c2[k];
      best = min(best, pack_key(dist, k));
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (tx == 0 && row < N) atomicMin(keys + row, best);
  }
}

}  // namespace

// x (N, D), codebooks (Q, K, D) -> out (N, D), idx (N, Q). Scratch from the
// caller: res (N, D), r2 (N,), c2 (Q, K) f32 and keys (N,) 64-bit. The
// shape rules are rvq_plan's in ops/quantize_cuda.py; a shape outside them
// returns cudaErrorInvalidValue before any launch.
extern "C" int rvq_encode(const float* x, const float* codebooks, float* out, int* idx, float* res, float* r2,
                          float* c2, unsigned long long* keys, int N, int Q, int K, int D, void* stream_) {
  if (N < 1 || Q < 1 || D < BK || D % BK != 0 || K < BN || K % BN != 0 || (N + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int smem = STAGES * (BM + BN) * LD * (int)sizeof(float);  // 27 KB: under the 48 KB default
  cudaError_t e;
  const dim3 grid(K / BN, (N + BM - 1) / BM);
  const int warps_per_block = NORM_THREADS / 32, row_blocks = (N + warps_per_block - 1) / warps_per_block;
  rvq_norms_kernel<<<(Q * K + N + warps_per_block - 1) / warps_per_block, NORM_THREADS, 0, stream>>>(
      x, codebooks, r2, c2, keys, N, Q * K, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int q = 0; q < Q; ++q) {
    const float* r = q == 0 ? x : res;
    rvq_distance_kernel<<<grid, DIST_THREADS, smem, stream>>>(r, codebooks + (size_t)q * K * D, r2,
                                                              c2 + (size_t)q * K, keys, N, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    rvq_apply_kernel<<<row_blocks, NORM_THREADS, 0, stream>>>(r, codebooks, res, out, idx, r2, keys, N, Q, K, q, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
