// DFL box decode fused with the per-anchor best class logit, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bsyolo_tpu/kernels/decode.py:124
// _decode_box_kernel (entry fused_box_best_pallas): for every anchor, the
// softmax expectation over 16 bins of each of the 4 box sides (l, t, r, b),
// the xyxy box in pixels (anchor -+ distance) * stride, and the max of the
// nc raw class logits (no sigmoid: NMS ranks raw logits).
//
// Layout: the head is read as the port's flattened NCHW maps, (B, no, A)
// float32, channel c of anchor a at head[(b * no + c) * A + a]. Outputs are
// boxes (B, A, 4) and best (B, A), float32.
//
// Bound: memory. Each anchor reads (64 + nc) * 4 bytes and writes 20; the
// arithmetic (about 100 operations per side) is far below the card's float32
// rate, so the least time is the bytes over the memory bandwidth.
//
// Design: one thread per anchor, blockIdx.y the image. Neighbouring threads
// read neighbouring anchors of one channel, so every load of a warp is one
// coalesced 128-byte line. Each side keeps its own max over its 16 bins
// before the exponentials, so a side whose logits sit far below another
// side's still has a finite sum (the TPU kernel's single max over all 64
// bins underflows such a side to 0/0). The 16 logits of a side stay in
// registers; nothing goes through shared memory. Anchor centres and strides
// come from the (A, 2) and (A, 1) arrays make_anchors builds, as in the TPU
// kernel: 12 bytes per anchor beside the 304 + 4 * nc of its head column,
// and the kernel stays free of the pyramid's level count and sizes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRegMax = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) decode_box_best_kernel(
    const float* __restrict__ head, const float* __restrict__ anchors, const float* __restrict__ strides,
    float* __restrict__ boxes, float* __restrict__ best, int A, int no, int nc) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  const int b = blockIdx.y;
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

  const float* c = p + (size_t)4 * kRegMax * A;
  float top = -INFINITY;
  for (int j = 0; j < nc; ++j) top = fmaxf(top, __ldg(c + (size_t)j * A));

  const float ax = __ldg(anchors + 2 * a), ay = __ldg(anchors + 2 * a + 1), s = __ldg(strides + a);
  const size_t o = (size_t)b * A + a;
  reinterpret_cast<float4*>(boxes)[o] =
      make_float4((ax - dist[0]) * s, (ay - dist[1]) * s, (ax + dist[2]) * s, (ay + dist[3]) * s);
  best[o] = top;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
int decode_box_best_f32(const float* head, const float* anchors, const float* strides, float* boxes, float* best,
                        int B, int A, int no, int nc, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  const dim3 grid((A + kThreads - 1) / kThreads, B);
  decode_box_best_kernel<<<grid, kThreads, 0, stream>>>(head, anchors, strides, boxes, best, A, no, nc);
  return (int)cudaGetLastError();
}

const char* decode_box_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
