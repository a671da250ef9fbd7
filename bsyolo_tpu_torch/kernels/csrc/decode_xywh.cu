// DFL box decode to xywh pixels with sigmoid class scores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bsyolo_tpu/kernels/decode.py:34
// _decode_kernel (entry fused_decode_pallas, wrapper decode_detections_pallas,
// the drop-in for nn/heads.decode_detections): for every anchor, the softmax
// expectation over 16 bins of each of the 4 box sides (l, t, r, b), the box
// ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1) * stride with
// x1 = ax - l, y1 = ay - t, x2 = ax + r, y2 = ay + b, then sigmoid of each of
// the nc class logits.
//
// Layout: the head is read as the port's flattened NCHW maps, (B, no, A)
// float32, channel c of anchor a at head[(b * no + c) * A + a]; channels past
// 64 + nc (a wider head's extras) are not read. The output is (B, A, 4 + nc)
// float32, anchors-first, the layout non_max_suppression consumes.
//
// Bound: memory. Each anchor reads (64 + nc) * 4 bytes of head and 12 of
// anchor and stride, and writes (4 + nc) * 4; about 400 operations for the box
// and 4 per class score are far below the card's float32 rate.
//
// Design: one thread per anchor, kThreads anchors per block, blockIdx.y the
// image. Reads: neighbouring threads read neighbouring anchors of one
// channel, so every load of a warp is one coalesced 128-byte line. Each side
// keeps its own max over its 16 bins before the exponentials (the TPU
// kernel's single max over all 64 bins underflows a side that sits far below
// another to 0/0). With 8 warps on an SM (B = 4, A = 8400) the time is the
// latency of each thread's loads, not the bytes, so a thread keeps many loads
// in flight: the 16 of a side at once, and the class logits 16 at a time into
// registers before their sigmoids (one serial load per class took twice as
// long). Writes: a thread's output row is 4 + nc floats, so direct
// stores from one thread per anchor would stride a warp's stores by that row.
// The block's rows are one contiguous run of kThreads * (4 + nc) floats in
// the output, so each thread first puts its row in shared memory (row pitch
// made odd, so the 32 threads of a warp hit 32 banks), and then the block
// writes the run out with consecutive threads on consecutive addresses.
// sigmoid uses expf, not __expf, so scores saturate to 1.0 where the CPU's do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRegMax = 16;
constexpr int kThreads = 128;
constexpr int kClassChunk = 16;  // class logits loaded together: nc = 12 in one round
constexpr int kDefaultSmem = 48 * 1024;  // above this, dynamic shared memory needs an opt-in

__host__ __device__ inline int row_pitch(int nc) { return (4 + nc) | 1; }

__global__ void __launch_bounds__(kThreads) decode_xywh_kernel(
    const float* __restrict__ head, const float* __restrict__ anchors, const float* __restrict__ strides,
    float* __restrict__ out, int A, int no, int nc) {
  extern __shared__ float rows[];  // kThreads rows of row_pitch(nc) floats
  const int a0 = blockIdx.x * kThreads;
  const int a = a0 + threadIdx.x;
  const int b = blockIdx.y;
  const int width = 4 + nc;
  const int pitch = row_pitch(nc);

  if (a < A) {
    const float* p = head + (size_t)b * no * A + a;
    float dist[4];
#pragma unroll
    for (int side = 0; side < 4; ++side) {
      float v[kRegMax];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < kRegMax; ++k) {
        v[k] = __ldg(p + (size_t)(side * kRegMax + k) * A);
        m = fmaxf(m, v[k]);
      }
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int k = 0; k < kRegMax; ++k) {
        const float e = expf(v[k] - m);
        den += e;
        num = fmaf(e, (float)k, num);
      }
      dist[side] = num / den;
    }
    const float ax = __ldg(anchors + 2 * a), ay = __ldg(anchors + 2 * a + 1), s = __ldg(strides + a);
    const float x1 = ax - dist[0], y1 = ay - dist[1], x2 = ax + dist[2], y2 = ay + dist[3];
    float* row = rows + threadIdx.x * pitch;
    row[0] = (x1 + x2) * 0.5f * s;
    row[1] = (y1 + y2) * 0.5f * s;
    row[2] = (x2 - x1) * s;
    row[3] = (y2 - y1) * s;
    const float* c = p + (size_t)4 * kRegMax * A;
    for (int j0 = 0; j0 < nc; j0 += kClassChunk) {  // kClassChunk loads in flight, then their sigmoids
      float v[kClassChunk];
#pragma unroll
      for (int k = 0; k < kClassChunk; ++k) v[k] = j0 + k < nc ? __ldg(c + (size_t)(j0 + k) * A) : 0.f;
#pragma unroll
      for (int k = 0; k < kClassChunk; ++k)
        if (j0 + k < nc) row[4 + j0 + k] = 1.f / (1.f + expf(-v[k]));
    }
  }
  __syncthreads();

  const int n = min(kThreads, A - a0) * width;
  float* dst = out + ((size_t)b * A + a0) * width;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / width;
    dst[i] = rows[r * pitch + (i - r * width)];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
int decode_xywh_f32(const float* head, const float* anchors, const float* strides, float* out, int B, int A, int no,
                    int nc, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  const int smem = kThreads * row_pitch(nc) * (int)sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(decode_xywh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((A + kThreads - 1) / kThreads, B);
  decode_xywh_kernel<<<grid, kThreads, smem, stream>>>(head, anchors, strides, out, A, no, nc);
  return (int)cudaGetLastError();
}

const char* decode_xywh_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
