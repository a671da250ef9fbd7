// Int8 matrix product with per-output-channel dequantization, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bsyolo_tpu/kernels/int8_matmul.py:38 _kernel
// (entry int8_matmul): out[m, n] = float(sum_k x[m, k] * w[k, n]) * (sx * sw[n]),
// the sum over int8 codes in int32, stored as float32 or bfloat16. The port's
// int8 convolutions (nn/modules.py Conv, int8 mode) run as this product: a 1x1
// convolution is (B*H*W, Cin) x (Cin, Cout), a k x k one the same after im2col.
//
// Layout: x is (M, K) int8 with K contiguous and rows ldx bytes apart; the
// weight is held transposed, (N, K) rows with K contiguous. Both are read by
// TMA, which needs a row pitch that is a multiple of 16 bytes and a 16-byte
// aligned start, but not a K that is: each tensor map's inner extent is K
// itself, and TMA fills whatever lies past K, M or N with zeros, which add
// nothing to an int32 sum. So the stem's K = 27 is read in place from rows
// 32 bytes apart, with no padded copy. sw is (N,) float32, sx a float32
// scalar on the device, out (M, N) row-major. Any M, N, K >= 1.
//
// Bound: bytes. At every shape of the yolo11n path (batch 4, 640 px: M from
// 1,600 to 409,600, K from 27 to 2,304, N from 16 to 256) the card needs
// longer to read the int8 operands and write the float32 output at 3.35 TB/s
// than to do the 2*M*N*K operations at the 1,979 TOP/s int8 tensor-core rate;
// the float32 output alone is 4*N bytes a row against K bytes of input. Where
// M is 1,600 or 6,400 the bytes take under 1 us, and the time is launch and
// latency: a few tiles, each a chain of loads and products.
//
// Design (the wrapper's tile_plan in kernels/int8_matmul.py picks the sizes):
// - Tensor cores through wgmma.mma_async m64nNk32 s8 x s8 -> s32, both operands
//   K-major in shared memory, the int32 sums in registers (exact in any order).
//   One or two consumer warpgroups, 64 rows each (BM = 64 or 128). The tile is
//   as wide as N needs, BN = 16, 32, 64, 128 or 256 (256 as two n128
//   products), so the stem's N = 16 wastes no columns; where that leaves fewer
//   tiles than SMs (M = 1,600), narrower tiles give more blocks.
// - A TMA pipeline: one producer thread fills a ring of up to 4 stages and
//   signals a "full" mbarrier with the bytes; the consumers multiply a stage and
//   release it through an "empty" mbarrier. A stage holds KB = 32, 64 or 128
//   bytes of K, the narrowest that holds K, in the swizzle of that width, so a
//   small K (the stem's 27, 48, 64) moves no zeros into shared memory.
// - The weight stays: where N fits one tile and blocks walk several tiles, the
//   producer loads the whole weight once, and the ring holds only x. Fetched
//   once per tile instead, the same few hundred bytes were read by every block
//   from the few L2 slices that hold them, which took longer than reading x
//   (the stem: 22.4 us against 16.7 us with the weight kept, on an H100).
// - Persistent: as many blocks as fit on the SMs at once, each walking tiles
//   blockIdx.x, + gridDim.x, ...; the producer runs ahead across tile
//   boundaries, so the next tile's loads overlap this tile's epilogue.
// - The epilogue multiplies each int32 sum, rounded to float, by sx * sw[n] in
//   that order (the plain version's order, so the two agree bit for bit),
//   stages up to 64 columns of the warpgroup's 64 rows in shared memory (pitch
//   padded by 8 elements, so the fragment writes use every bank) and writes
//   them out as 16-byte stores, consecutive threads on consecutive addresses:
//   where the tile spans all N, its rows are one contiguous run.
// - Tried and not kept: x copied by a producer warpgroup with cp.async instead
//   of TMA (within 1 % over the path's products), 8 stages (no faster), 64-row
//   tiles at large M (slower), sums stored straight from registers (slower).
//   Not tried: split-K.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;  // shared memory one block may use on sm_90 (227 KB)
constexpr int kMaxDevices = 16;

// Error codes of the C entries besides cudaError_t values (which are positive).
constexpr int kNoEncoder = -1;    // libcuda offers no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = -2;  // it refused an operand's layout
constexpr int kBadPlan = -3;      // no kernel for this tile plan, or it does not fit on an SM

// Shapes of one instantiation: KB bytes of K per stage, 32, 64 or 128, each row of a stage one
// row of the swizzle of that width. kernels/int8_matmul.py smem_bytes mirrors smem_bytes.
template <int BM, int BN, int KB, typename Out>
struct Tile {
  static constexpr int kConsumers = BM / 64;              // warpgroups that multiply, 64 rows each
  static constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp
  static constexpr int kWgmmaN = BN < 128 ? BN : 128;     // width of one wgmma instruction
  static constexpr int kChunk = BN < 64 ? BN : 64;        // output columns staged at a time
  static constexpr int kPitch = kChunk + 8;               // staged row pitch, in Out elements
  static constexpr int kStagingBytes = kConsumers * 64 * kPitch * (int)sizeof(Out);
  // 1024 bytes of slack to align the swizzled tiles, the stages of x, the weight's buffers (one per
  // stage, or one per K step where the weight stays), the staging rows, the barriers
  static constexpr int smem_bytes(int stages, int b_bufs) {
    return 1024 + (stages * BM + b_bufs * BN) * KB + kStagingBytes + (2 * kMaxStages + 1) * 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive, and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box at (k, row) of `map` into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile as TMA wrote it in the KB-byte swizzle: rows of KB
// bytes, 8-row groups 8 * KB bytes apart (the stride byte offset; the leading one is unused
// in these layouts), layout type 1, 2 or 3 for the 128-, 64- or 32-byte swizzle.
template <int KB>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  constexpr uint64_t layout = KB == 128 ? 1 : KB == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(8 * KB >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of the sums across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_sums(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D(64 x N) += A(64 x 32) * B(32 x N), A and B int8 in shared memory (descriptors), D int32 in
// registers: thread t of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 * j + 2 * (t % 4) (+ 1), at d[4 * j + 2 * (row + 8) + (column + 1)].
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void stage2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void stage2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int BM, int BN, int KB, typename Out>
__global__ void __launch_bounds__(Tile<BM, BN, KB, Out>::kThreads, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ sw, const float* __restrict__ sx, Out* __restrict__ out, int M,
                       int N, int K, int stages, int resident) {
  using T = Tile<BM, BN, KB, Out>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* a_smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // stages x BM rows x KB bytes
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int ktiles = (K + KB - 1) / KB;
  uint8_t* b_smem = a_smem + stages * BM * KB;  // (resident ? ktiles : stages) x BN rows x KB bytes
  Out* staging = reinterpret_cast<Out*>(b_smem + (resident ? ktiles : stages) * BN * KB);  // 64 x kPitch a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(staging) + T::kStagingBytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* weight_full = empty + kMaxStages;  // the resident weight has landed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                    // the producer's arrival, plus the stage's bytes
      mbar_init(&empty[s], T::kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init(weight_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T::kConsumers * 4) {  // the producer warp: one thread keeps the ring filled
    if (lane == 0) {
      if (resident) {  // the whole weight, once: every tile of this block multiplies by it
        mbar_expect_tx(weight_full, ktiles * BN * KB);
        for (int kt = 0; kt < ktiles; ++kt) tma_load(b_smem + kt * BN * KB, &wmap, kt * KB, 0, weight_full);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);  // passes at once in the first round
          mbar_expect_tx(&full[s], (BM + (resident ? 0 : BN)) * KB);
          tma_load(a_smem + s * BM * KB, &xmap, kt * KB, m0, &full[s]);
          if (!resident) tma_load(b_smem + s * BN * KB, &wmap, kt * KB, n0, &full[s]);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 * wg .. 64 * wg + 63 of each tile
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int row = tid / 32 * 16 + lane / 4;  // this thread's rows: row and row + 8
  const int pair = lane % 4 * 2;             // its columns: pair and pair + 1 of every 8
  const float scale_x = __ldg(sx);
  Out* rows_out = staging + wg * 64 * T::kPitch;
  int s = 0;
  uint32_t phase = 0;
  if (resident) mbar_wait(weight_full, 0);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_sums<BN / 2>(acc);
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[s], phase);
      const uint64_t da = smem_desc<KB>(a_smem + s * BM * KB + wg * 64 * KB);
      const uint64_t db = smem_desc<KB>(b_smem + (resident ? kt : s) * BN * KB);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)  // 32 bytes of K an instruction: +2 in the descriptors' 16-byte units
#pragma unroll
        for (int h = 0; h < BN / T::kWgmmaN; ++h)
          wgmma_s8<T::kWgmmaN>(acc + h * T::kWgmmaN / 2, da + 2 * kk, db + 2 * kk + h * (T::kWgmmaN * KB / 16));
      wgmma_commit();
      wgmma_wait_all();
      fence_sums<BN / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }

    // epilogue: kChunk columns at a time through this warpgroup's staging rows
    constexpr int kVec = 16 / (int)sizeof(Out), kRowVecs = T::kChunk / kVec;
    const bool whole_vectors = N % kVec == 0;  // then every 16-byte piece of a row is aligned, and in or out of N
#pragma unroll
    for (int c = 0; c < BN / T::kChunk; ++c) {
#pragma unroll
      for (int j = 0; j < T::kChunk / 8; ++j) {
        const int col = j * 8 + pair, n = n0 + c * T::kChunk + col;
        const float s0 = n < N ? scale_x * __ldg(sw + n) : 0.f;
        const float s1 = n + 1 < N ? scale_x * __ldg(sw + n + 1) : 0.f;
        const int* d = acc + (c * T::kChunk / 8 + j) * 4;
        stage2(rows_out + row * T::kPitch + col, __int2float_rn(d[0]) * s0, __int2float_rn(d[1]) * s1);
        stage2(rows_out + (row + 8) * T::kPitch + col, __int2float_rn(d[2]) * s0, __int2float_rn(d[3]) * s1);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's rows are staged
#pragma unroll
      for (int i = 0; i < 64 * kRowVecs / 128; ++i) {
        const int v = tid + i * 128, r = v / kRowVecs, cv = v % kRowVecs * kVec;
        const int m = m0 + wg * 64 + r, n = n0 + c * T::kChunk + cv;
        if (m >= M || n >= N) continue;
        const Out* src = rows_out + r * T::kPitch + cv;
        Out* dst = out + (size_t)m * N + n;
        if (whole_vectors) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < kVec && n + e < N; ++e) dst[e] = src[e];
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // read out before the next chunk is staged
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime, so the library needs no libcuda at link time.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of (rows, k) int8 codes, k contiguous, rows `pitch` bytes apart, read in boxes of
// kb bytes of k by box_rows rows, in the kb-byte swizzle; whatever lies outside reads as zero.
int encode(CUtensorMap* map, const void* base, long long rows, long long k, long long pitch, int kb, int box_rows) {
  if (kb != 32 && kb != 64 && kb != 128) return kBadPlan;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)kb, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         kb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : kb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

int sm_count(int device) {
  static int count[kMaxDevices] = {};
  if (count[device] == 0) cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
  return count[device];
}

struct Args {
  CUtensorMap xmap, wmap;
  const float* sw;
  const float* sx;
  void* out;
  int M, N, K, stages, resident, device;
  cudaStream_t stream;
};

template <int BM, int BN, int KB, typename Out>
int launch(const Args& a) {
  using T = Tile<BM, BN, KB, Out>;
  const auto kernel = int8_matmul_kernel<BM, BN, KB, Out>;
  const int ktiles = (a.K + KB - 1) / KB;
  const int smem = T::smem_bytes(a.stages, a.resident ? ktiles : a.stages);
  if (a.stages < 1 || a.stages > kMaxStages || smem > kSmemLimit || (a.resident && a.N > BN)) return kBadPlan;
  // per device: the shared memory the kernel was allowed, and blocks per SM at the sizes met so far
  constexpr int kKnown = 8;
  static int allowed[kMaxDevices] = {};
  static int known_smem[kMaxDevices][kKnown] = {}, known_blocks[kMaxDevices][kKnown] = {};
  int err;
  if (allowed[a.device] < smem) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))) return err;
    allowed[a.device] = smem;
  }
  int slot = 0;
  while (slot < kKnown - 1 && known_smem[a.device][slot] != 0 && known_smem[a.device][slot] != smem) ++slot;
  int& blocks = known_blocks[a.device][slot];
  if (known_smem[a.device][slot] != smem) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, T::kThreads, smem))) return err;
    if (blocks == 0) return kBadPlan;
    known_smem[a.device][slot] = smem;
  }
  const long long tiles = (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  const int grid = (int)(tiles < (long long)blocks * sm_count(a.device) ? tiles : (long long)blocks * sm_count(a.device));
  kernel<<<grid, T::kThreads, smem, a.stream>>>(a.xmap, a.wmap, a.sw, a.sx, static_cast<Out*>(a.out), a.M, a.N, a.K,
                                                a.stages, a.resident);
  return (int)cudaGetLastError();
}

template <int BM, int KB, typename Out>
int launch_width(int bn, const Args& a) {
  switch (bn) {
    case 16: return launch<BM, 16, KB, Out>(a);
    case 32: return launch<BM, 32, KB, Out>(a);
    case 64: return launch<BM, 64, KB, Out>(a);
    case 128: return launch<BM, 128, KB, Out>(a);
    case 256: return BM == 64 ? launch<64, 256, KB, Out>(a) : kBadPlan;  // 128 x 256 sums: too many registers
    default: return kBadPlan;
  }
}

template <int KB, typename Out>
int launch_rows(int bm, int bn, const Args& a) {
  if (bm == 64) return launch_width<64, KB, Out>(bn, a);
  if (bm == 128) return launch_width<128, KB, Out>(bn, a);
  return kBadPlan;
}

template <typename Out>
int launch_plan(int bm, int bn, int kb, const Args& a) {
  if (kb == 32) return launch_rows<32, Out>(bm, bn, a);
  if (kb == 64) return launch_rows<64, Out>(bm, bn, a);
  if (kb == 128) return launch_rows<128, Out>(bm, bn, a);
  return kBadPlan;
}

}  // namespace

extern "C" {

// Encode the tensor map of the weight, (N, K) int8 rows `pitch` bytes apart, read in stages of
// kb bytes of K by bn rows, into the 128 bytes at `map` (a CUtensorMap). Returns 0, or an error code.
int int8_matmul_weight_map(void* map, const int8_t* wt, int N, int K, long long pitch, int kb, int bn) {
  CUtensorMap m;
  const int rc = encode(&m, wt, N, K, pitch, kb, bn);
  if (rc == 0) memcpy(map, &m, sizeof m);
  return rc;
}

// out (M, N) = x (M, K; rows ldx bytes apart) times the weight of `wmap` (from int8_matmul_weight_map
// with the same kb and bn), dequantized; float32 when out_bf16 is 0, else bfloat16. The tile plan
// (bm, bn, kb, stages, resident) comes from kernels/int8_matmul.py tile_plan. Launches on `stream`
// on `device` (made current for the launch only) and returns 0 or an error code.
int int8_matmul_s8(const int8_t* x, long long ldx, const void* wmap, const float* sw, const float* sx, void* out,
                   int out_bf16, int M, int N, int K, int bm, int bn, int kb, int stages, int resident, int device,
                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  Args a;
  int rc = encode(&a.xmap, x, M, K, ldx, kb, bm);
  if (rc) return rc;
  memcpy(&a.wmap, wmap, sizeof a.wmap);
  a.sw = sw;
  a.sx = sx;
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.stages = stages;
  a.resident = resident;
  a.device = device;
  a.stream = stream;
  int current;
  if ((rc = cudaGetDevice(&current))) return rc;
  if (current != device && (rc = cudaSetDevice(device))) return rc;
  rc = out_bf16 ? launch_plan<__nv_bfloat16>(bm, bn, kb, a) : launch_plan<float>(bm, bn, kb, a);
  if (current != device) cudaSetDevice(current);
  return rc;
}

const char* int8_matmul_error_string(int code) {
  switch (code) {
    case kNoEncoder: return "libcuda offers no cuTensorMapEncodeTiled";
    case kEncodeFailed: return "cuTensorMapEncodeTiled refused an operand's layout";
    case kBadPlan: return "no int8_matmul kernel for this tile plan, or it does not fit on an SM";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
