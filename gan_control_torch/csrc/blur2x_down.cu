// blur2x_down: 2x downsample with a 4-tap separable FIR (pad 1, stride 2), NHWC.
//
// Replaces the Pallas blur2x_down / _blur_down_kernel
// (gan_control_tpu/ops/pallas_kernels.py:125-175). The TPU version padded the
// input and deinterleaved it into four phase planes in XLA (Mosaic cannot
// lower stride-2 vector slices), then summed 16 shifted slices. Here each
// thread computes one output pixel and channel as the 16-term sum read
// strided in place, with no padded copy and no deinterleave pass:
//
//   along one axis, with correlation coefficients k0..k3,
//     out[i] = k0 * x[2i-1] + k1 * x[2i] + k2 * x[2i+1] + k3 * x[2i+2]
//   so output pixel (u, v) sums (ki * kj) * x[2u-1+i, 2v-1+j].
//
// Taps that fall outside the input are dropped by bounds checks (zero pad).
// The same kernel is the backward of blur2x_up (csrc/blur2x_up.cu) with the
// coefficients reversed; the wrapper passes them.
//
// Bound on an H100: device-memory bytes. The input is 4x the output and each
// output element costs 16 multiply-adds: about two operations per byte moved
// in f32 (four in bf16), far below the ~20 per byte where the card's f32
// units become the limit. One thread computes one output element;
// consecutive threads take consecutive channels and columns, so the stores
// are coalesced, and each input element is read by at most 4 outputs,
// through L1/L2. On the generator's path C = 3 (the ToRGB skip): too narrow
// for vector loads along C, so the simple element-per-thread form is kept.
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
  float k[4];
};

template <typename T>
__global__ void blur2x_down_kernel(const T* __restrict__ x, T* __restrict__ out,
                                   int h, int w, int c, int64_t total, Taps t) {
  const int ho = h >> 1;
  const int wo = w >> 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int ch = (int)(idx % c);
    int64_t r = idx / c;
    const int v = (int)(r % wo);
    r /= wo;
    const int u = (int)(r % ho);
    const int64_t n = r / ho;

    const T* img = x + n * (int64_t)h * w * c + ch;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = 2 * u - 1 + i;
      if (iy < 0 || iy >= h) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ix = 2 * v - 1 + j;
        if (ix < 0 || ix >= w) continue;
        acc += (t.k[i] * t.k[j]) * load_f32(img + ((int64_t)iy * w + ix) * c);
      }
    }
    store_f32(out + idx, acc);
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, float k0,
           float k1, float k2, float k3, void* stream) {
  const int64_t total = (int64_t)n * (h / 2) * (w / 2) * c;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // grid-stride loop: cap the grid at a few waves of the 132 SMs
  const int64_t max_blocks = 132 * 32;
  if (blocks > max_blocks) blocks = max_blocks;
  blur2x_down_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, h, w, c, total, Taps{{k0, k1, k2, k3}});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blur2x_down_f32(const void* x, void* out, int n, int h, int w,
                               int c, float k0, float k1, float k2, float k3,
                               void* stream) {
  return launch<float>(x, out, n, h, w, c, k0, k1, k2, k3, stream);
}

extern "C" int blur2x_down_bf16(const void* x, void* out, int n, int h, int w,
                                int c, float k0, float k1, float k2, float k3,
                                void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, k0, k1, k2, k3, stream);
}
