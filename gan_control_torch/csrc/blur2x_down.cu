// blur2x_down: 2x downsample with a 4-tap separable FIR (pad 1, stride 2), NHWC.
//
// Replaces the Pallas blur2x_down / _blur_down_kernel
// (gan_control_tpu/ops/pallas_kernels.py:125-175). The TPU version padded the
// input and deinterleaved it into four phase planes in XLA (Mosaic cannot
// lower stride-2 vector slices), then summed 16 shifted slices. Here the
// strided taps are read in place, with no padded copy and no deinterleave
// pass:
//
//   along one axis, with correlation coefficients k0..k3,
//     out[i] = k0 * x[2i-1] + k1 * x[2i] + k2 * x[2i+1] + k3 * x[2i+2]
//
// The same kernel is the backward of blur2x_up (csrc/blur2x_up.cu) with the
// coefficients reversed, and the other way round; the wrapper passes them.
//
// Bound on an H100: device-memory bytes. The input is 4x the output and each
// output element costs 16 multiply-adds, about four operations per byte moved
// in bf16. On the generator's path C = 3, so the design works on the flat
// NHWC row, not on pixels:
//
//  - no staging: a thread owns one element of the flat output row (a pixel
//    and channel, 32-bit index math from the 2-D grid) and walks down a band
//    of up to kRows output rows (fewer where the output is small, so that
//    the launch still has enough threads). Per output row it reads the four horizontal taps
//    of the two new input rows straight from device memory and keeps the
//    last two rows' horizontal sums in registers, so each output costs two
//    new rows, and each input element is fetched from device memory once
//    (the two threads whose windows share it meet in L1);
//  - the kernel is bound by its instructions rather than by the memory
//    (its input, written just before by the layer above, mostly sits in the
//    50 MB L2), so the loop is kept lean: row pointers advance by addition,
//    the image's top and bottom zero rows are handled outside it, and it is
//    unrolled so that a thread has several rows' loads in flight. With no
//    shared memory and no barrier, every SM runs as many warps as its
//    registers allow. A version that staged the rows in shared memory with
//    16-byte asynchronous copies, as blur2x_up does, was slower: its blocks
//    waited at barriers while their copies were in flight;
//  - consecutive threads take consecutive outputs, so the loads and the
//    stores of a warp are coalesced whatever C is, and no row needs an
//    aligned start.
//
// Storage f32 or bf16, arithmetic in f32, rounded once. The kernel runs on
// the stream it is given, allocates nothing, and the C entry points return
// cudaGetLastError() (cudaErrorInvalidValue for a shape beyond its indexing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // output rows per thread, at most
// the threads a launch aims at, a few hundred per SM of an H100: where the
// output is small, fewer rows per thread give it that many
constexpr int64_t kThreadsWanted = 132 * 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Geometry {
  int n, h, w, c;      // input shape
  int n_span;          // blocks along the flat output row
  int rows, n_band;    // output rows per thread, bands of them
  float k0, k1, k2, k3;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    blur2x_down_kernel(const T* __restrict__ x, T* __restrict__ out, Geometry g) {
  const int n = blockIdx.y + blockIdx.z * gridDim.y;  // the batch may exceed one grid axis
  if (n >= g.n) return;
  const int span = blockIdx.x % g.n_span;
  const int band = blockIdx.x / g.n_span;
  const int c = g.c, ho = g.h >> 1, wc = g.w * c, owc = (g.w >> 1) * c;
  const int q = span * kThreads + threadIdx.x;  // element of the flat output row
  if (q >= owc) return;
  const int ox = q / c, ch = q - ox * c;
  // taps j = 0..3 at input pixels 2ox - 1 + j; the outer two may fall outside
  const bool left = ox > 0, right = 2 * ox + 2 < g.w;
  auto hsum = [&](const T* p) {  // p: tap 0 of this column in an input row
    float s = g.k1 * to_f32(p[c]) + g.k2 * to_f32(p[2 * c]);
    if (left) s += g.k0 * to_f32(p[0]);
    if (right) s += g.k3 * to_f32(p[3 * c]);
    return s;
  };
  // output row u reads input rows 2u - 1 .. 2u + 2; rows -1 and h are zero.
  // Pointers advance row by row: no 64-bit multiply in the loop.
  const int u0 = band * g.rows, u1 = min(u0 + g.rows, ho);
  const T* p = x + (int64_t)n * g.h * wc + (int64_t)(2 * u0) * wc + (2 * ox - 1) * c + ch;
  float h0 = u0 > 0 ? hsum(p - wc) : 0.f, h1 = hsum(p);  // rows 2u0 - 1, 2u0
  p += wc;                                                // row 2u0 + 1
  T* o = out + ((int64_t)n * ho + u0) * owc + q;
  const int last = u1 == ho ? u1 - 1 : u1;  // the image's last output row reads row h
#pragma unroll 4
  for (int u = u0; u < last; ++u) {
    const float h2 = hsum(p), h3 = hsum(p + wc);
    store(o, g.k0 * h0 + g.k1 * h1 + g.k2 * h2 + g.k3 * h3);
    h0 = h2;
    h1 = h3;
    p += 2 * wc;
    o += owc;
  }
  if (last < u1) store(o, g.k0 * h0 + g.k1 * h1 + g.k2 * hsum(p));
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, const float* k, void* stream) {
  if ((int64_t)n * (h / 2) * (w / 2) * c == 0) return (int)cudaGetLastError();
  if ((int64_t)w * c > INT32_MAX) return (int)cudaErrorInvalidValue;
  Geometry g{n, h, w, c, 0, 0, 0, k[0], k[1], k[2], k[3]};
  const int64_t outputs = (int64_t)n * (h / 2) * (w / 2) * c;
  const int64_t rows = (outputs + kThreadsWanted - 1) / kThreadsWanted;
  g.rows = rows < kRows ? (int)rows : kRows;
  g.n_span = ((w / 2) * c + kThreads - 1) / kThreads;
  g.n_band = (h / 2 + g.rows - 1) / g.rows;
  const int64_t blocks = (int64_t)g.n_span * g.n_band;
  const int ny = n < 65535 ? n : 65535;
  const int nz = (n + ny - 1) / ny;
  if (blocks > INT32_MAX || nz > 65535) return (int)cudaErrorInvalidValue;
  blur2x_down_kernel<T><<<dim3((unsigned)blocks, ny, nz), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, h, w, c] with h and w even; out: [n, h/2, w/2, c]; k: the four
// correlation coefficients (host memory)
extern "C" int blur2x_down_f32(const void* x, void* out, int n, int h, int w, int c,
                               const float* k, void* stream) {
  return launch<float>(x, out, n, h, w, c, k, stream);
}

extern "C" int blur2x_down_bf16(const void* x, void* out, int n, int h, int w, int c,
                                const float* k, void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, k, stream);
}
