// blur2x_up: 2x upsample with a 4-tap separable FIR (gain 4), NHWC.
//
// Replaces the Pallas blur2x_up / _blur_up_kernel
// (gan_control_tpu/ops/pallas_kernels.py:178-264). The TPU version wrote four
// phase planes, one per grid program, and XLA interleaved them afterwards
// (:261-264). Here every output pixel is computed in place from the
// polyphase form and the interleaved output is written directly:
//
//   along one axis, with correlation taps k0..k3 (per-axis gain 2),
//     out[2u]   = k0 * x[u-1] + k2 * x[u]
//     out[2u+1] = k1 * x[u]   + k3 * x[u+1]
//   so output pixel (2u+a, 2v+b) is a 4-term sum of input pixels.
//
// Edges are zero-padded by bounds checks, not by a padded copy.
//
// Bound on an H100: device-memory bytes. The output is 4x the input and each
// output element costs 4 multiply-adds: under two operations per byte moved,
// against the ~20 per byte at which the card's f32 units become the limit.
// One thread computes one output element; consecutive threads take
// consecutive channels and columns, so the stores are coalesced and the four
// input reads of neighbouring threads hit the same cache lines (each input
// element is read by at most 4 outputs, through L1/L2, not from DRAM again).
// On the generator's path C = 3 (the ToRGB skip), too narrow for vector
// loads along C, so the simple element-per-thread form is kept.
//
// Storage f32 or bf16, arithmetic in f32. The kernel runs on the stream it is
// given, allocates nothing, and the C entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Taps {
  float k0, k1, k2, k3;
};

template <typename T>
__global__ void blur2x_up_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int h, int w, int c, int64_t total, Taps t) {
  const int h2 = 2 * h;
  const int w2 = 2 * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int ch = (int)(i % c);
    int64_t r = i / c;
    const int ox = (int)(r % w2);
    r /= w2;
    const int oy = (int)(r % h2);
    const int64_t n = r / h2;
    const int u = oy >> 1;
    const int v = ox >> 1;

    int y0, y1, x0, x1;
    float cy0, cy1, cx0, cx1;
    if (oy & 1) {
      y0 = u;     cy0 = t.k1;
      y1 = u + 1; cy1 = t.k3;
    } else {
      y0 = u - 1; cy0 = t.k0;
      y1 = u;     cy1 = t.k2;
    }
    if (ox & 1) {
      x0 = v;     cx0 = t.k1;
      x1 = v + 1; cx1 = t.k3;
    } else {
      x0 = v - 1; cx0 = t.k0;
      x1 = v;     cx1 = t.k2;
    }
    const bool y0_in = y0 >= 0 && y0 < h;
    const bool y1_in = y1 >= 0 && y1 < h;
    const bool x0_in = x0 >= 0 && x0 < w;
    const bool x1_in = x1 >= 0 && x1 < w;

    const T* img = x + n * (int64_t)h * w * c + ch;
    float acc = 0.f;
    if (y0_in && x0_in) acc += (cy0 * cx0) * load_f32(img + ((int64_t)y0 * w + x0) * c);
    if (y0_in && x1_in) acc += (cy0 * cx1) * load_f32(img + ((int64_t)y0 * w + x1) * c);
    if (y1_in && x0_in) acc += (cy1 * cx0) * load_f32(img + ((int64_t)y1 * w + x0) * c);
    if (y1_in && x1_in) acc += (cy1 * cx1) * load_f32(img + ((int64_t)y1 * w + x1) * c);
    store_f32(out + i, acc);
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, float k0,
           float k1, float k2, float k3, void* stream) {
  const int64_t total = (int64_t)n * 4 * h * w * c;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // grid-stride loop: cap the grid at a few waves of the 132 SMs
  const int64_t max_blocks = 132 * 32;
  if (blocks > max_blocks) blocks = max_blocks;
  blur2x_up_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, h, w, c, total, Taps{k0, k1, k2, k3});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blur2x_up_f32(const void* x, void* out, int n, int h, int w,
                             int c, float k0, float k1, float k2, float k3,
                             void* stream) {
  return launch<float>(x, out, n, h, w, c, k0, k1, k2, k3, stream);
}

extern "C" int blur2x_up_bf16(const void* x, void* out, int n, int h, int w,
                              int c, float k0, float k1, float k2, float k3,
                              void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, k0, k1, k2, k3, stream);
}
