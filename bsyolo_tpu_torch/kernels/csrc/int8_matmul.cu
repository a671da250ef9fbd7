// Int8 matrix product with per-output-channel dequantization, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bsyolo_tpu/kernels/int8_matmul.py:38 _kernel
// (entry int8_matmul): out[m, n] = float(sum_k x[m, k] * w[k, n]) * (sx * sw[n]),
// the sum over int8 codes in int32, stored as float32 or bfloat16. The port's
// int8 convolutions (nn/modules.py Conv, int8 mode) run as this product: a 1x1
// convolution is (B*H*W, Cin) x (Cin, Cout), a k x k one the same after im2col.
//
// Layout: x is (M, K) int8, row-major; the weight is held transposed, wt is
// (N, K) int8 row-major, so both operands are read with K contiguous. K must be
// a multiple of 16 and both pointers 16-byte aligned (the wrapper zero-pads K
// and copies an unaligned operand; zero codes add nothing, so padding is
// exact). M and N are any size >= 1: rows and columns past them are masked.
// sw is (N,) float32, sx a float32 scalar on the device, out (M, N) row-major.
//
// Bound: bytes. At every shape of the yolo11n path (batch 4, 640 px: M from
// 1,600 to 409,600, K from 27 to 2,304, N from 16 to 256) the card needs
// longer to read the int8 operands and write the float32 output at 3.35 TB/s
// than to do the 2*M*N*K operations at the 1,979 TOP/s int8 tensor-core rate;
// the float32 output alone is 4*N bytes a row against K bytes of input.
//
// Design, right and simple first: each block computes a 64 x 64 output tile
// with 4 warps, each warp a 32 x 32 quarter as 2 x 4 tensor-core products
// mma.sync m16n8k32 (int8 in, int32 sums kept in registers, exact). K advances
// 64 bytes at a time through shared memory, two stages: cp.async copies the
// next 64 x 64 tiles of x and wt (16 bytes a thread, zero-filled past M, N or
// K) while the warps multiply the current ones, so the loads of one step
// overlap the products of the previous. Rows in shared memory have a pitch of
// 80 bytes, so the 4-byte fragment loads of a warp (8 rows, 4 words each) hit
// 32 different banks. The epilogue multiplies each int32 sum, rounded to
// float, by sx * sw[n] in that order (the plain version's order, so the two
// agree bit for bit) and stores it; a block's rows are written as 32-byte
// runs. Not done yet, for a later PR: wgmma and TMA, a tile shaped to small N
// (the stem's N = 16 uses a quarter of the 64-wide tile), vector stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kPitch = kBK + 16;  // bytes per shared-memory row: conflict-free fragment loads
constexpr int kThreads = 128;
constexpr int kChunks = kBM * kBK / 16 / kThreads;  // 16-byte copies per thread per operand and stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A * B + D, A 16 x 32 (row), B 32 x 8 (col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) { return *reinterpret_cast<const unsigned*>(p); }

__device__ __forceinline__ void store(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) { out[i] = __float2bfloat16_rn(v); }

template <typename Out>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wt, const float* __restrict__ sw,
    const float* __restrict__ sx, Out* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t xs[2][kBM * kPitch];
  __shared__ __align__(16) int8_t ws[2][kBN * kPitch];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair of this lane
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kBK / 16), kc = (c % (kBK / 16)) * 16;
      const int k = k0 + kc;
      const bool kin = k < K;  // K is a multiple of 16: a chunk is wholly inside or outside
      const bool xin = kin && m0 + row < M, win = kin && n0 + row < N;
      cp_async16(&xs[stage][row * kPitch + kc], xin ? x + (size_t)(m0 + row) * K + k : x, xin);
      cp_async16(&ws[stage][row * kPitch + kc], win ? wt + (size_t)(n0 + row) * K + k : wt, win);
    }
    cp_async_commit();
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int steps = (K + kBK - 1) / kBK;
  load_stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_stage((s + 1) & 1, (s + 1) * kBK);  // that stage was last read before the barrier ending step s - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* xa = xs[s & 1];
    const int8_t* wb = ws[s & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = xa + (wm + i * 16 + g) * kPitch + kk + t * 4;
        a[i][0] = ld32(p);                    // row g,     k t*4 .. t*4+3
        a[i][1] = ld32(p + 8 * kPitch);       // row g + 8, k t*4 .. t*4+3
        a[i][2] = ld32(p + 16);               // row g,     k 16+t*4 ..
        a[i][3] = ld32(p + 8 * kPitch + 16);  // row g + 8, k 16+t*4 ..
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = wb + (wn + j * 8 + g) * kPitch + kk + t * 4;
        b[j][0] = ld32(p);       // column g, k t*4 .. t*4+3
        b[j][1] = ld32(p + 16);  // column g, k 16+t*4 ..
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  const float scale_x = __ldg(sx);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + t * 2;  // this lane's two columns: n, n + 1
    const float s0 = n < N ? scale_x * __ldg(sw + n) : 0.f;
    const float s1 = n + 1 < N ? scale_x * __ldg(sw + n + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // h = 0: row g, h = 1: row g + 8
        const int m = m0 + wm + i * 16 + g + h * 8;
        if (m >= M) continue;
        const size_t o = (size_t)m * N + n;
        if (n < N) store(out, o, __int2float_rn(acc[i][j][2 * h]) * s0);
        if (n + 1 < N) store(out, o + 1, __int2float_rn(acc[i][j][2 * h + 1]) * s1);
      }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; out is float32 when out_bf16 is 0, else bfloat16.
// Returns the cudaError_t of the launch (0 on success).
int int8_matmul_s8(const int8_t* x, const int8_t* wt, const float* sw, const float* sx, void* out, int out_bf16,
                   int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(x, wt, sw, sx,
                                                                     static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    int8_matmul_kernel<float><<<grid, kThreads, 0, stream>>>(x, wt, sw, sx, static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

const char* int8_matmul_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
