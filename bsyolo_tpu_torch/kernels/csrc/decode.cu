// DFL box decode of the Detect head's per-level maps, for Hopper (sm_90a): the
// ports of both Pallas decode kernels in one source, one epilogue each.
//
// Replaces bsyolo_tpu/kernels/decode.py:124 _decode_box_kernel (entry
// fused_box_best_pallas; epilogue kBox) and bsyolo_tpu/kernels/decode.py:34
// _decode_kernel (entry fused_decode_pallas, wrapper decode_detections_pallas;
// epilogue kXywh). For every anchor: the softmax expectation over 16 bins of
// each box side (l, t, r, b), x1 = ax - l, y1 = ay - t, x2 = ax + r, y2 = ay + b,
// and then
// - kBox: boxes (B, A, 4) = (x1, y1, x2, y2) * stride, best (B, A) the max raw
//   class logit, cls (B, A, nc) the raw class logits, anchors first (the NMS
//   gathers rows of it);
// - kXywh: out (B, A, 4 + nc) = ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
//   y2 - y1) * stride, then the sigmoid of each class logit.
// Each side keeps its own max over its 16 bins before the exponentials (the
// TPU kernels' single max over all 64 bins underflows a side that sits far
// below another to 0/0).
//
// Input: the head's maps as Detect returns them, up to 4 levels of (B, no, H, W)
// float32, each contiguous; channel c of cell i = h * W + w of image b at
// map[(b * no + c) * H * W + i]; channels past 64 + nc are not read. Anchors run
// level by level, then by cell. The centre of cell i is (i % W + 0.5, i / W + 0.5)
// in the level's units and its stride comes from the level table: exactly the
// values make_anchors builds (an integer + 0.5 is exact in float32), so no
// anchor or stride array is read and no flattened copy of the head is made.
//
// Bound: memory. Each anchor reads (64 + nc) * 4 bytes and writes (5 + nc) * 4
// (kBox) or (4 + nc) * 4 (kXywh); about 400 float32 operations per anchor are far
// below the card's rate.
//
// Design: a block takes T consecutive cells of one level of one image with 4T
// threads. T is 32 (each channel row of a tile is one 128-byte line) or, where
// that leaves fewer than two blocks per SM, 16, 8 or 4 (kernels/decode.py
// tile_anchors; tiles of 64 and 128 cells measured slower on the H100: each
// block then waits longer for the last line of its tile). A block first copies
// its whole tile, 64 + nc channel rows of T floats, into shared memory with
// cp.async, every copy issued before any arithmetic, where one thread per
// anchor loading side by side had 16 loads of 4 bytes in flight; the 64 DFL
// rows and the class rows are two groups, so the expectations start while the
// class rows still land. The copies are 16 bytes where the level allows it
// (H * W a multiple of 4 and the map 16-byte aligned), else 4 bytes (a 17 x 17
// level). Each thread takes one side of one anchor for the expectation and then
// every fourth class of that anchor (max and copy, or sigmoid), and thread
// a < T assembles anchor a's box. Class rows (kBox) and whole output rows
// (kXywh) are staged in shared memory at an odd pitch, so a warp's anchors hit
// distinct banks, and the block writes its rows, one contiguous run of the
// output, with consecutive threads on consecutive addresses, 16 bytes a thread
// where the row width is a multiple of 4 floats. The sigmoid uses expf, not
// __expf, so scores saturate to 1.0 where the CPU's do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRegMax = 16;
constexpr int kMaxLevels = 4;
constexpr int kMaxDevices = 16;
constexpr int kBadTile = 100001;  // no instantiation for the tile, or it does not fit on an SM

enum Epilogue { kBox = 0, kXywh = 1 };

// The shape of the pyramid, filled once per shape by kernels/decode.py (_LevelTable, field for field).
struct LevelTable {
  int hw[kMaxLevels];     // H * W
  int w[kMaxLevels];      // W
  int first[kMaxLevels];  // the level's first anchor among an image's A
  int tile0[kMaxLevels];  // the level's first tile among an image's tiles
  float stride[kMaxLevels];
  int levels, tiles, anchors;  // levels used, tiles per image, A
};

struct Level {
  const float* map;
  int hw, w, first, tile0, vec;  // vec: 16-byte copies
  float stride;
};

struct Params {
  Level lv[kMaxLevels];
  int levels, anchors, no, nc;
  float* out0;  // kBox: boxes; kXywh: out
  float* out1;  // kBox: best
  float* out2;  // kBox: cls
};

__host__ __device__ constexpr int row_width(int epilogue, int nc) { return epilogue == kBox ? nc : 4 + nc; }
__host__ __device__ constexpr int row_pitch(int epilogue, int nc) { return row_width(epilogue, nc) | 1; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>  // wait until at most kPending of this thread's groups are still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int E, int T>
__global__ void __launch_bounds__(4 * T) decode_kernel(const Params p) {
  constexpr int kThreads = 4 * T;
  extern __shared__ __align__(16) float smem[];  // the tile, rows x T; then the staged rows, T x pitch
  __shared__ float dist[4][T];                   // each side's expectation
  __shared__ float part[4][T];                   // kBox: each side-thread's max over its classes

  // this block's level (constant indices only, so the table stays in the parameter bank)
  Level L = p.lv[0];
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k)
    if (k < p.levels && (int)blockIdx.x >= p.lv[k].tile0) L = p.lv[k];
  const int tid = threadIdx.x, b = blockIdx.y, nc = p.nc;
  const int i0 = ((int)blockIdx.x - L.tile0) * T;  // the tile's first cell in its level
  const int n = min(T, L.hw - i0);
  const int rows = 4 * kRegMax + nc, width = row_width(E, nc), pitch = row_pitch(E, nc);
  float* tile = smem;
  float* stage = smem + rows * T;

  // 1. the whole tile into shared memory, every copy in flight before any arithmetic: the 64 DFL rows
  // in one group, the class rows in a second, so the expectations start while the class rows land
  const float* src = L.map + (size_t)b * p.no * L.hw + i0;
  auto copy_rows = [&](int r0, int r1) {
    if (L.vec) {  // H * W % 4 == 0, so n % 4 == 0 and every 16 bytes lie inside or outside the level
      constexpr int kQuads = T / 4;
      for (int q = tid; q < (r1 - r0) * kQuads; q += kThreads) {
        const int r = r0 + q / kQuads, c = (q % kQuads) * 4;
        if (c < n) cp_async16(tile + r * T + c, src + (size_t)r * L.hw + c);
      }
    } else {
      for (int e = tid; e < (r1 - r0) * T; e += kThreads) {
        const int r = r0 + e / T, c = e % T;
        if (c < n) cp_async4(tile + r * T + c, src + (size_t)r * L.hw + c);
      }
    }
    cp_async_commit();
  };
  copy_rows(0, 4 * kRegMax);
  copy_rows(4 * kRegMax, rows);

  // 2. one side of one anchor per thread, then every fourth class of that anchor
  const int side = tid / T, a = tid % T;
  cp_async_wait<1>();  // this thread's DFL rows; the barrier makes every thread's visible
  __syncthreads();
  if (a < n) {
    const float* v = tile + side * kRegMax * T + a;
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kRegMax; ++k) m = fmaxf(m, v[k * T]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int k = 0; k < kRegMax; ++k) {
      const float e = expf(v[k * T] - m);
      den += e;
      num = fmaf(e, (float)k, num);
    }
    dist[side][a] = num / den;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (a < n) {
    const float* cls = tile + 4 * kRegMax * T + a;
    float* row = stage + a * pitch + (E == kBox ? 0 : 4);
    float top = -INFINITY;
    for (int j = side; j < nc; j += 4) {
      const float x = cls[j * T];
      if (E == kBox) {
        top = fmaxf(top, x);
        row[j] = x;
      } else {
        row[j] = 1.f / (1.f + expf(-x));
      }
    }
    if (E == kBox) part[side][a] = top;
  }
  __syncthreads();

  // 3. anchor a's box from its four sides
  if (tid < n) {
    const int i = i0 + tid;
    const float ax = (float)(i % L.w) + 0.5f, ay = (float)(i / L.w) + 0.5f, s = L.stride;
    const float x1 = ax - dist[0][tid], y1 = ay - dist[1][tid], x2 = ax + dist[2][tid], y2 = ay + dist[3][tid];
    if (E == kBox) {
      const size_t o = (size_t)b * p.anchors + L.first + i;
      reinterpret_cast<float4*>(p.out0)[o] = make_float4(x1 * s, y1 * s, x2 * s, y2 * s);
      p.out1[o] = fmaxf(fmaxf(part[0][tid], part[1][tid]), fmaxf(part[2][tid], part[3][tid]));
    } else {
      float* row = stage + tid * pitch;
      row[0] = (x1 + x2) * 0.5f * s;
      row[1] = (y1 + y2) * 0.5f * s;
      row[2] = (x2 - x1) * s;
      row[3] = (y2 - y1) * s;
    }
  }
  if (E == kXywh) __syncthreads();  // kBox's staged class rows were complete at the last barrier

  // 4. the staged rows: one contiguous run of n * width floats of the output
  float* dst = (E == kBox ? p.out2 : p.out0) + ((size_t)b * p.anchors + L.first + i0) * width;
  if (width % 4 == 0) {
    const int quads = n * width / 4;
    for (int q = tid; q < quads; q += kThreads) {
      const int e = q * 4, r = e / width, c = e - r * width;
      const float* s = stage + r * pitch + c;
      reinterpret_cast<float4*>(dst)[q] = make_float4(s[0], s[1], s[2], s[3]);
    }
  } else {
    for (int e = tid; e < n * width; e += kThreads) {
      const int r = e / width;
      dst[e] = stage[r * pitch + (e - r * width)];
    }
  }
}

template <int E, int T>
int launch(const Params& p, int B, int tiles, int device, cudaStream_t stream) {
  const auto kernel = decode_kernel<E, T>;
  const int smem = (int)sizeof(float) * (4 * kRegMax + p.nc + row_pitch(E, p.nc)) * T;
  // per device: the dynamic shared memory the kernel was allowed, set at its first launch and when a
  // larger nc needs more (the default allows 48 KB less the static dist and part arrays)
  static int allowed[kMaxDevices] = {};
  if (smem > allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed[device] = smem;
  }
  kernel<<<dim3(tiles, B), 4 * T, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int E>
int launch_tile(int tile, const Params& p, int B, int tiles, int device, cudaStream_t stream) {
  switch (tile) {
    case 4: return launch<E, 4>(p, B, tiles, device, stream);
    case 8: return launch<E, 8>(p, B, tiles, device, stream);
    case 16: return launch<E, 16>(p, B, tiles, device, stream);
    case 32: return launch<E, 32>(p, B, tiles, device, stream);
    default: return kBadTile;
  }
}

}  // namespace

extern "C" {

// Decode B images of the pyramid `level_table` (a LevelTable, from kernels/decode.py _layout)
// whose level maps are m0..m3 (unused levels null), `no` channels each, nc classes, in tiles of
// `tile` cells. epilogue 0 (kBox) writes out0 boxes (B, A, 4), out1 best (B, A), out2 cls
// (B, A, nc); epilogue 1 (kXywh) writes out0 (B, A, 4 + nc). Launches on `stream` on `device`
// (made current for the launch only) and returns 0 or an error code.
int decode_levels_f32(int epilogue, const void* level_table, int tile, const float* m0, const float* m1,
                      const float* m2, const float* m3, int B, int no, int nc, float* out0, float* out1, float* out2,
                      int device, cudaStream_t stream) {
  const LevelTable* table = static_cast<const LevelTable*>(level_table);
  if ((epilogue != kBox && epilogue != kXywh) || B <= 0 || nc <= 0 || table->levels < 1 ||
      table->levels > kMaxLevels || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const float* maps[kMaxLevels] = {m0, m1, m2, m3};
  Params p = {};
  for (int l = 0; l < table->levels; ++l) {
    p.lv[l] = {maps[l], table->hw[l], table->w[l], table->first[l], table->tile0[l],
               table->hw[l] % 4 == 0 && reinterpret_cast<uintptr_t>(maps[l]) % 16 == 0, table->stride[l]};
  }
  p.levels = table->levels;
  p.anchors = table->anchors;
  p.no = no;
  p.nc = nc;
  p.out0 = out0;
  p.out1 = out1;
  p.out2 = out2;
  int current, rc;
  if ((rc = cudaGetDevice(&current))) return rc;
  if (current != device && (rc = cudaSetDevice(device))) return rc;
  rc = epilogue == kBox ? launch_tile<kBox>(tile, p, B, table->tiles, device, stream)
                        : launch_tile<kXywh>(tile, p, B, table->tiles, device, stream);
  if (current != device) cudaSetDevice(current);
  return rc;
}

const char* decode_error_string(int code) {
  return code == kBadTile ? "no decode kernel for this tile, or it does not fit on an SM"
                          : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
