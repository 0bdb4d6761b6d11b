// blur_sep: stride-1 separable FIR correlation with zero pads, NHWC.
//
// Replaces the Pallas blur_sep / _blur_sep_kernel and its custom VJP
// (gan_control_tpu/ops/pallas_kernels.py:272-384):
//
//   out[u, v] = sum_{i,j < K} rt[i] * ct[j] * xp[u + i, v + j]
//
// over the input zero-padded by (p0, p1) on both axes, K <= 8 taps, and
// 0 <= p <= K-1. The backward is this kernel again with the taps reversed and
// the pads K-1-p (the wrapper passes them). On the discriminator's path it is
// the pre-blur of every stride-2 conv: K = 4, pads (2, 2) before the 3x3 conv
// and (1, 1) before the 1x1 skip.
//
// The TPU kernel DMA'd a row slab of a padded copy of the input into VMEM,
// ran the H pass into scratch and the W pass out. On Hopper one block takes a
// tile of TH x TW output pixels x CHUNK channels:
//   1. it loads the (TH+K-1) x (TW+K-1) input patch into shared memory as f32,
//      writing zeros where the patch reaches the pad (no padded copy in device
//      memory);
//   2. the H pass sums K rows of the patch into a second shared buffer of
//      TH x (TW+K-1);
//   3. the W pass sums K columns of that buffer and stores the tile.
// Accumulation is in f32, storage f32 or bf16.
//
// Bound on an H100: device-memory bytes. Each output costs 2K multiply-adds
// (16 at K = 4) against one element read and one written: 2-4 operations per
// byte, below the ~20 per byte where the card's f32 units become the limit.
// Threads are laid out with the 32 lanes of a warp on 32 consecutive channels
// of one pixel, so each global load and store of a warp is one contiguous run
// (128 bytes in f32, 64 in bf16), and the shared-memory rows are indexed
// [pixel][lane], free of bank conflicts. The chunk of 32 channels fills the
// card at both ends of the pyramid: C = 64 at 512 px gives 2 chunks x 4225
// tiles per image, C = 512 at 8 px gives 16 chunks x 4 tiles per image. The
// halo costs (TH+K-1)(TW+K-1)/(TH TW) = 1.9x the input reads at K = 4; the
// re-reads come from L2.
//
// The kernel runs on the stream it is given, allocates nothing, and the C
// entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kChunk = 32;  // channels per block = lanes of a warp
constexpr int kRowsOfThreads = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Taps {
  float v[kMaxTaps];
};

template <typename T>
__global__ void blur_sep_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int h, int w, int c, int k, int p0, int h_out,
                                int w_out, int tiles_w, Taps rt, Taps ct) {
  extern __shared__ float smem[];
  const int pw = kTileW + k - 1;      // patch width
  const int ph = kTileH + k - 1;      // patch height
  float* patch = smem;                // [ph][pw][kChunk]
  float* rows = smem + ph * pw * kChunk;  // [kTileH][pw][kChunk]

  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int ch = blockIdx.y * kChunk + lane;
  const bool ch_in = ch < c;
  const int64_t n = blockIdx.z;
  const T* img = x + n * (int64_t)h * w * c;

  // 1. patch of the padded input: padded row oy0 + r is input row oy0 + r - p0
  for (int idx = ty; idx < ph * pw; idx += kRowsOfThreads) {
    const int r = idx / pw;
    const int s = idx - r * pw;
    const int iy = oy0 + r - p0;
    const int ix = ox0 + s - p0;
    float v = 0.f;
    if (ch_in && iy >= 0 && iy < h && ix >= 0 && ix < w)
      v = load_f32(img + ((int64_t)iy * w + ix) * c + ch);
    patch[idx * kChunk + lane] = v;
  }
  __syncthreads();

  // 2. H pass: rows[r][s] = sum_i rt[i] * patch[r + i][s]
  for (int idx = ty; idx < kTileH * pw; idx += kRowsOfThreads) {
    const int r = idx / pw;
    const int s = idx - r * pw;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i)
      if (i < k) acc += rt.v[i] * patch[((r + i) * pw + s) * kChunk + lane];
    rows[idx * kChunk + lane] = acc;
  }
  __syncthreads();

  // 3. W pass: out[r][s] = sum_j ct[j] * rows[r][s + j]
  if (!ch_in) return;
  T* dst = out + n * (int64_t)h_out * w_out * c;
  for (int idx = ty; idx < kTileH * kTileW; idx += kRowsOfThreads) {
    const int r = idx / kTileW;
    const int s = idx - r * kTileW;
    const int oy = oy0 + r;
    const int ox = ox0 + s;
    if (oy >= h_out || ox >= w_out) continue;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j)
      if (j < k) acc += ct.v[j] * rows[(r * pw + s + j) * kChunk + lane];
    store_f32(dst + ((int64_t)oy * w_out + ox) * c + ch, acc);
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, int k, int p0,
           int p1, const float* row_taps, const float* col_taps, void* stream) {
  if (k < 1 || k > kMaxTaps || p0 < 0 || p1 < 0 || p0 > k - 1 || p1 > k - 1)
    return (int)cudaErrorInvalidValue;
  const int h_out = h + p0 + p1 - k + 1;
  const int w_out = w + p0 + p1 - k + 1;
  if (n == 0 || c == 0 || h_out <= 0 || w_out <= 0) return (int)cudaGetLastError();
  Taps rt{}, ct{};
  for (int i = 0; i < k; ++i) {
    rt.v[i] = row_taps[i];
    ct.v[i] = col_taps[i];
  }
  const int tiles_h = (h_out + kTileH - 1) / kTileH;
  const int tiles_w = (w_out + kTileW - 1) / kTileW;
  const int pw = kTileW + k - 1;
  const size_t smem = (size_t)((kTileH + k - 1) * pw + kTileH * pw) * kChunk * sizeof(float);
  const dim3 grid((unsigned)(tiles_h * tiles_w), (unsigned)((c + kChunk - 1) / kChunk),
                  (unsigned)n);
  const dim3 block(kChunk, kRowsOfThreads);
  blur_sep_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, h, w, c, k, p0, h_out, w_out, tiles_w, rt, ct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blur_sep_f32(const void* x, void* out, int n, int h, int w, int c,
                            int k, int p0, int p1, const float* row_taps,
                            const float* col_taps, void* stream) {
  return launch<float>(x, out, n, h, w, c, k, p0, p1, row_taps, col_taps, stream);
}

extern "C" int blur_sep_bf16(const void* x, void* out, int n, int h, int w, int c,
                             int k, int p0, int p1, const float* row_taps,
                             const float* col_taps, void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, k, p0, p1, row_taps, col_taps,
                               stream);
}
