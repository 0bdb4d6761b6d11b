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
// and (1, 1) before the 1x1 skip, at batch 16 on inputs of up to 537 MB in
// bf16 ([16, 512, 512, 64]).
//
// The TPU kernel DMA'd a row slab of a padded copy of the input into VMEM and
// ran an H pass into scratch and a W pass out of it. Here no padded copy is
// made, and a thread keeps a rolling window of rows in registers:
//
//   a thread owns one unit of an output row (a 16-byte vector of channels of
//   one pixel, or one channel) and walks a band of output rows down its
//   column. Per output row it takes one new input row: the K horizontal taps
//   of its unit, summed in f32. It keeps the last K - 1 such sums in
//   registers, and their vertical K-tap sum with the new one is the output.
//   The sum runs horizontal-then-vertical (the plain version runs vertical-
//   then-horizontal: the same products, rounded in another order).
//
// Bound on an H100: device-memory bytes. Each output costs 2K multiply-adds
// against one element read and one written, 2-4 operations per byte in bf16,
// below the ~20 per byte where the f32 units become the limit; the four
// largest levels of the path exceed the 50 MB L2, so their reads stream from
// HBM. Two variants; the wrapper picks one from C and the input's alignment:
//
//  - staged (16-byte vector units; C a multiple of the vector, the input
//    16-byte aligned; every shape of the path): a block takes a tile of TW
//    output columns x CB channels (CB x itemsize = up to 128 bytes) and a
//    band of about 8 output rows. One thread streams the band's input rows
//    into a ring of 8 shared-memory buffers with TMA, through a 4-D tensor
//    map over [N, H, W, C] whose out-of-bounds fill writes the zero pads,
//    rows and columns alike, so the loop has no edge case at all. Each
//    buffer completes on its own mbarrier; one barrier per row frees the
//    buffer for the next copy. The copies keep up to 8 rows (~36 KB) of a
//    block in flight, which is what HBM needs (about 18 KB per SM), and they
//    spend no thread's registers or instructions. Tiles are balanced along
//    W (513 columns make 17 tiles of 31, not 16 of 32 and one of 1).
//    The K horizontal taps of a thread are 16-byte reads of the buffer, a
//    warp's 32 of them one contiguous 512-byte run: free of bank conflicts.
//    The direct kernel below with the same vector lanes (each thread
//    loading its taps from device memory, the neighbours' overlap served by
//    L1) is slower at every level of the path: 16-21 % longer at 64 px and
//    above on an H100 80GB HBM3 at 700 W, as measured by
//    gan_control_torch/tools/blur_sep_sweep.py. Its loads keep fewer bytes
//    in flight, and at C >= 256 a tap's neighbours lie in other warps;
//  - direct (one channel a thread: any C, any alignment): the same rolling
//    loop with the taps read straight from device memory; consecutive
//    threads take consecutive channels of the flat output row, so a warp's
//    loads and stores are coalesced whatever C is. Bands of 1-16 rows, fewer
//    where the output is small, so that the launch still has enough threads.
//    The top and bottom zero rows are handled outside the loop, the zero
//    columns by a per-thread tap mask computed once.
//
// Both keep 32-bit offsets inside an image (64-bit only for the image base)
// and advance row pointers by addition: no division, 64-bit multiply or
// bounds check in a loop. One block axis walks (tile, band, image), so the
// batch has no 65535 cap. Each variant is instantiated for K = 4 (the path)
// and for any K <= 8 (taps in a by-value struct; the vertical taps right-
// aligned in 8 register slots). Storage f32 or bf16, arithmetic in f32,
// rounded once. The kernels run on the stream they are given, allocate
// nothing, and the C entry points return cudaGetLastError()
// (cudaErrorInvalidValue for arguments or a shape beyond the kernels'
// indexing).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;   // per block, at most
constexpr int kMaxRows = 16;    // output rows per thread, at most
constexpr int kStages = 8;      // staged: input rows in flight per block
constexpr int kChunkBytes = 128;  // staged: channels of a tile, in bytes

struct Taps {
  float rt[kMaxTaps];  // vertical taps, right-aligned: rt[KT - k + i] = row tap i
  float ct[kMaxTaps];  // horizontal taps ct[0..k-1]
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&b);
}

// s += tap * (the L channels at p), in f32
template <typename T, int L>
__device__ __forceinline__ void fma_unit(const T* p, float tap, float (&s)[L]) {
  if constexpr (L == 1) {
    s[0] = fmaf(tap, to_f32(*p), s[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    s[0] = fmaf(tap, v.x, s[0]);
    s[1] = fmaf(tap, v.y, s[1]);
    s[2] = fmaf(tap, v.z, s[2]);
    s[3] = fmaf(tap, v.w, s[3]);
  } else {  // 8 bf16: element 2i in the low half of word i
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[2 * i] = fmaf(tap, __uint_as_float(wd[i] << 16), s[2 * i]);
      s[2 * i + 1] = fmaf(tap, __uint_as_float(wd[i] & 0xffff0000u), s[2 * i + 1]);
    }
  }
}

template <typename T, int L>
__device__ __forceinline__ void store_unit(T* p, const float (&f)[L]) {
  if constexpr (L == 1) {
    store1(p, f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                              pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
}

// The vertical half of the sum: the horizontal sums of the last KT - 1 input
// rows, slot m holding row u - p0 + m - (KT - k) of output row u. Slots below
// KT - k take no part (a row that has left the window never reaches an
// output, inf or NaN included).
template <int L, int K>
struct Window {
  static constexpr int KT = K ? K : kMaxTaps;  // tap slots in registers
  float hr[KT - 1][L];

  __device__ __forceinline__ void clear(int m) {
#pragma unroll
    for (int l = 0; l < L; ++l) hr[m][l] = 0.f;
  }
  // the output row whose last input row has horizontal sum s; s shifts in
  __device__ __forceinline__ void step(const float (&s)[L], const Taps& t, int k, float (&y)[L]) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < KT - 1; ++m)
        if (K || m >= KT - k) a = fmaf(t.rt[m], hr[m][l], a);
      y[l] = fmaf(t.rt[KT - 1], s[l], a);
    }
#pragma unroll
    for (int m = 0; m < KT - 2; ++m)
#pragma unroll
      for (int l = 0; l < L; ++l) hr[m][l] = hr[m + 1][l];
#pragma unroll
    for (int l = 0; l < L; ++l) hr[KT - 2][l] = s[l];
  }
};

// ---------------------------------------------------------------------------
// staged variant: TMA row copies into a ring of shared-memory buffers
// ---------------------------------------------------------------------------

struct Staged {
  int ho, wo, c, p0, k;
  int rows;             // output rows per block
  int tw, cb;           // tile: output columns, channels
  int n_cx, n_cc, n_band;
  int stage_elems;      // (tw + k - 1) * cb, rounded up to 128 bytes
  unsigned stage_bytes; // the box a copy delivers
  Taps taps;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void copy_row(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         unsigned bytes, int c0, int x0, int y, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(c0), "r"(x0), "r"(y), "r"(n)
      : "memory");
}

// Waits for a buffer's copy. Bounded: a copy that never lands traps (a launch
// error) rather than hanging the card.
__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  for (int tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == 1 << 24) asm volatile("trap;");
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    blur_sep_staged(const __grid_constant__ CUtensorMap map, T* __restrict__ out, const Staged g) {
  constexpr int L = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * g.stage_elems * sizeof(T));
  const int k = K ? K : g.k;
  int b = blockIdx.x;
  const int cx = b % g.n_cx;
  b /= g.n_cx;
  const int cc = b % g.n_cc;
  b /= g.n_cc;
  const int band = b % g.n_band;
  const int img = b / g.n_band;
  const int ox0 = cx * g.tw, c0 = cc * g.cb;
  const int u0 = band * g.rows;
  const int n_in = min(g.rows, g.ho - u0) + k - 1;  // input rows u0 - p0 ...
  const int y0 = u0 - g.p0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && s < n_in; ++s)
      copy_row(ring + s * g.stage_elems, &map, &full[s], g.stage_bytes, c0, ox0 - g.p0, y0 + s, img);
  const int units = g.cb / L;
  const int col = threadIdx.x / units;
  const int ox = ox0 + col;
  const bool active = ox < g.wo;
  const T* src = ring + col * g.cb + (threadIdx.x - col * units) * L;
  T* o = out + ((int64_t)img * g.ho + u0) * g.wo * g.c + ox * g.c + c0 + (threadIdx.x - col * units) * L;
  const int owc = g.wo * g.c;
  Window<L, K> win;
  constexpr int KT = Window<L, K>::KT;
#pragma unroll
  for (int m = 0; m < KT - 1; ++m) win.clear(m);
  for (int i = 0; i < n_in; ++i) {
    const int s = i % kStages;
    wait_phase(&full[s], (i / kStages) & 1);
    float h[L];
#pragma unroll
    for (int l = 0; l < L; ++l) h[l] = 0.f;
    const T* p = src + s * g.stage_elems;
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (K || j < k) fma_unit<T, L>(p + j * g.cb, g.taps.ct[j], h);
    float y[L];
    win.step(h, g.taps, k, y);
    if (i >= k - 1) {  // rows before carry the first output row's window
      if (active) store_unit<T, L>(o, y);
      o += owc;
    }
    __syncthreads();  // every thread is done with buffer s
    if (threadIdx.x == 0 && i + kStages < n_in)
      copy_row(ring + s * g.stage_elems, &map, &full[s], g.stage_bytes, c0, ox0 - g.p0,
               y0 + i + kStages, img);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", (void**)&fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&fn, cudaEnableDefault, &found);
#endif
    if (found != cudaDriverEntryPointSuccess) fn = nullptr;
  }
  return fn;
}

template <typename T>
int launch_staged(const T* x, T* out, int n, int h, int w, int c, int k, int p0, int p1,
                  int rows, const float* taps, cudaStream_t stream) {
  constexpr int L = 16 / sizeof(T);
  Staged g{};
  g.ho = h + p0 + p1 - k + 1, g.wo = w + p0 + p1 - k + 1, g.c = c, g.p0 = p0, g.k = k;
  g.rows = rows;
  // channels of a tile: the largest power-of-two number of vectors up to
  // kChunkBytes that divides c
  g.cb = L;
  while (g.cb * 2 * (int)sizeof(T) <= kChunkBytes && c % (g.cb * 2) == 0) g.cb *= 2;
  const int units = g.cb / L;
  const int tw_max = min(kThreads / units, 256 - (k - 1));  // a box side is at most 256
  g.n_cx = (g.wo + tw_max - 1) / tw_max;
  g.tw = (g.wo + g.n_cx - 1) / g.n_cx;
  g.n_cc = c / g.cb;
  g.n_band = (g.ho + rows - 1) / rows;
  g.stage_bytes = (unsigned)((g.tw + k - 1) * g.cb * sizeof(T));
  g.stage_elems = (int)(((g.stage_bytes + 127) / 128) * 128 / sizeof(T));
  const int slot = k == 4 ? 0 : kMaxTaps - k;  // the K = 4 kernel holds 4 slots
  for (int i = 0; i < k; ++i) {
    g.taps.rt[slot + i] = taps[i];
    g.taps.ct[i] = taps[kMaxTaps + i];
  }
  const int64_t blocks = (int64_t)g.n_cx * g.n_cc * g.n_band * n;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;

  const auto encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * sizeof(T), (cuuint64_t)w * c * sizeof(T),
                                 (cuuint64_t)h * w * c * sizeof(T)};
  const cuuint32_t box[4] = {(cuuint32_t)g.cb, (cuuint32_t)(g.tw + k - 1), 1, 1};
  const cuuint32_t unit_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      &map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<T*>(x), dims, strides, box, unit_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out-of-bounds elements read as zeros
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const size_t smem = kStages * (g.stage_elems * sizeof(T) + sizeof(uint64_t));
  const int threads = g.tw * units;
  if (k == 4)
    blur_sep_staged<T, 4><<<(unsigned)blocks, threads, smem, stream>>>(map, out, g);
  else
    blur_sep_staged<T, 0><<<(unsigned)blocks, threads, smem, stream>>>(map, out, g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// direct variant: taps read from device memory. The wrapper runs it with one
// channel a thread (L = 1); with 16-byte vector lanes it is the alternative
// that gan_control_torch/tools/blur_sep_sweep.py times against the staged one.
// ---------------------------------------------------------------------------

struct Direct {
  int h, w, c, ho, wo, p0, p1, k;
  int rows;            // output rows per thread
  int n_span, n_band;  // blocks along the flat output row, bands of rows
  Taps taps;
};

template <typename T, int L, int K>
__global__ void __launch_bounds__(kThreads)
    blur_sep_direct(const T* __restrict__ x, T* __restrict__ out, const Direct g) {
  constexpr int KT = Window<L, K>::KT;
  const int k = K ? K : g.k;
  int b = blockIdx.x;
  const int span = b % g.n_span;
  b /= g.n_span;
  const int band = b % g.n_band;
  const int img = b / g.n_band;
  const int c = g.c;
  const int q = (span * kThreads + threadIdx.x) * L;  // element of the flat output row
  const int owc = g.wo * c;
  if (q >= owc) return;
  const int ox = q / c;
  const int wc = g.w * c;
  // tap j reads input column ox - p0 + j: in the image or a zero column
  unsigned taps_in = 0;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int ix = ox - g.p0 + j;
    if (j < k && ix >= 0 && ix < g.w) taps_in |= 1u << j;
  }
  // tap 0 of this element in input row 0 (before the row's start where ox < p0)
  const T* xi = x + (int64_t)img * g.h * wc + (q - g.p0 * c);
  auto hsum = [&](const T* r, float (&s)[L]) {
#pragma unroll
    for (int l = 0; l < L; ++l) s[l] = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (taps_in >> j & 1u) fma_unit<T, L>(r + j * c, g.taps.ct[j], s);
  };
  const int u0 = band * g.rows;
  const int u1 = min(u0 + g.rows, g.ho);
  Window<L, K> win;
#pragma unroll
  for (int m = 0; m < KT - 1; ++m) {
    const int iy = u0 - g.p0 + m - (KT - k);
    if (m >= KT - k && iy >= 0 && iy < g.h)
      hsum(xi + iy * wc, win.hr[m]);
    else
      win.clear(m);
  }
  // rows u < ho - p1 take a new input row inside the image; the last p1 a zero row
  const int ua = min(u1, g.ho - g.p1);
  const T* r = xi + (u0 - g.p0 + k - 1) * wc;
  T* o = out + (int64_t)img * g.ho * owc + u0 * owc + q;
  float s[L], y[L];
  int u = u0;
#pragma unroll 1
  for (; u < ua; ++u) {
    hsum(r, s);
    win.step(s, g.taps, k, y);
    store_unit<T, L>(o, y);
    r += wc;
    o += owc;
  }
  for (; u < u1; ++u) {
#pragma unroll
    for (int l = 0; l < L; ++l) s[l] = 0.f;
    win.step(s, g.taps, k, y);
    store_unit<T, L>(o, y);
    o += owc;
  }
}

template <typename T, int L>
int launch_direct(const T* x, T* out, int n, int h, int w, int c, int k, int p0, int p1,
                  int rows, const float* taps, cudaStream_t stream) {
  Direct g{};
  g.h = h, g.w = w, g.c = c, g.ho = h + p0 + p1 - k + 1, g.wo = w + p0 + p1 - k + 1;
  g.p0 = p0, g.p1 = p1, g.k = k, g.rows = rows;
  g.n_span = (g.wo * c / L + kThreads - 1) / kThreads;
  g.n_band = (g.ho + rows - 1) / rows;
  const int slot = k == 4 ? 0 : kMaxTaps - k;
  for (int i = 0; i < k; ++i) {
    g.taps.rt[slot + i] = taps[i];
    g.taps.ct[i] = taps[kMaxTaps + i];
  }
  const int64_t blocks = (int64_t)g.n_span * g.n_band * n;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (k == 4)
    blur_sep_direct<T, L, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(x, out, g);
  else
    blur_sep_direct<T, L, 0><<<(unsigned)blocks, kThreads, 0, stream>>>(x, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, int k, int p0, int p1,
           int lanes, int rows, const float* taps, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (k < 1 || k > kMaxTaps || p0 < 0 || p1 < 0 || p0 > k - 1 || p1 > k - 1 || rows < 1 ||
      rows > kMaxRows || n < 0 || h < 0 || w < 0 || c < 0)
    return (int)cudaErrorInvalidValue;
  if (lanes != 1 && (lanes != kVec || c % kVec || ((uintptr_t)x | (uintptr_t)out) % 16))
    return (int)cudaErrorInvalidValue;
  const int ho = h + p0 + p1 - k + 1, wo = w + p0 + p1 - k + 1;
  if (ho <= 0 || wo <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || c == 0) return (int)cudaGetLastError();
  // 32-bit offsets inside an image, the tap columns included
  if ((int64_t)(h + k) * (w + k) * c > INT32_MAX || (int64_t)(ho + 1) * wo * c > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  if (lanes == 1 || h == 0 || w == 0)  // an empty input gives zeros: no tensor map for it
    return launch_direct<T, 1>((const T*)x, (T*)out, n, h, w, c, k, p0, p1, rows, taps, s);
  return launch_staged<T>((const T*)x, (T*)out, n, h, w, c, k, p0, p1, rows, taps, s);
}

}  // namespace

// x: [n, h, w, c]; out: [n, h + p0 + p1 - k + 1, w + p0 + p1 - k + 1, c];
// lanes: channels per thread, 1 (direct variant) or 16 bytes' worth (staged
// variant: c a multiple of it, both pointers 16-byte aligned); rows: output
// rows per thread (1..16); taps: host array of 2 x 8 floats, the k row taps
// at [0, k) and the k column taps at [8, 8 + k)
extern "C" int blur_sep_f32(const void* x, void* out, int n, int h, int w, int c, int k,
                            int p0, int p1, int lanes, int rows, const float* taps,
                            void* stream) {
  return launch<float>(x, out, n, h, w, c, k, p0, p1, lanes, rows, taps, stream);
}

extern "C" int blur_sep_bf16(const void* x, void* out, int n, int h, int w, int c, int k,
                             int p0, int p1, int lanes, int rows, const float* taps,
                             void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, k, p0, p1, lanes, rows, taps, stream);
}
