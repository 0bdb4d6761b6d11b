// blur2x_up: 2x upsample with a 4-tap separable FIR (gain 4), NHWC.
//
// Replaces the Pallas blur2x_up / _blur_up_kernel
// (gan_control_tpu/ops/pallas_kernels.py:178-264). The TPU version wrote four
// phase planes, one per grid program, and XLA interleaved them afterwards
// (:261-264). Here the interleaved output is written directly from the
// polyphase form:
//
//   along one axis, with correlation taps k0..k3 (per-axis gain 2),
//     out[2u]   = k0 * x[u-1] + k2 * x[u]
//     out[2u+1] = k1 * x[u]   + k3 * x[u+1]
//
// Bound on an H100: device-memory bytes. The output is 4x the input and each
// output element costs 4 multiply-adds, under two operations per byte moved.
// On the generator's path C = 3 (the ToRGB skip), so the design works on the
// flat NHWC row, not on pixels:
//
//  - a block takes one image, a band of up to kRows input rows and a span of
//    the row (all channels when C <= kMaxChannelTile), and stages the band's
//    rows with the one-row, one-pixel zero halo in shared memory, so every
//    input element is read from device memory once. An NHWC row is W*C
//    contiguous elements and a pixel's neighbour sits C elements away, so a
//    staged row is one contiguous run of memory, copied in aligned 16-byte
//    pieces (cp.async) whatever C, W and the tensor's start address are: the
//    run lands in shared memory at the same offset modulo 16 bytes as in
//    device memory, and only the pieces that cross the row's ends are copied
//    element by element. Wider tensors are split into tiles of
//    kMaxChannelTile channels, one run per pixel;
//  - a thread owns a column of output pairs (q, q+1) of the flat output row
//    and walks down the band: per input row it forms the horizontal 2-tap
//    sum of each of its two outputs once from shared memory and keeps the
//    last three rows' sums in registers, from which both output rows 2u and
//    2u+1 follow with two multiply-adds each;
//  - the pair is stored as one 4-byte (bf16) or 8-byte (f32) word, so a
//    warp writes 128 or 256 contiguous bytes per row (the output is 80 % of
//    the bytes).
//
// Inside a block all index math is 32-bit; only an image's base offset and a
// row's offset in it are 64-bit. The image index runs over grid y and z, so
// the batch may exceed the 65535 of one grid axis. Storage f32 or bf16,
// arithmetic in f32, rounded once. The kernel runs on the stream it is given,
// allocates nothing, and the C entry points return cudaGetLastError()
// (cudaErrorInvalidValue for a shape beyond its indexing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;              // input rows per tile at most: 16 output rows
constexpr int kMaxChannelTile = 256;  // a multiple of every vector width
constexpr int kTileElems = 1024;      // pixels x channels of a tile row
constexpr int kMaxSmem = 48 * 1024;   // dynamic shared memory without an opt-in

template <typename T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }  // elements per 16 bytes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) { *p = __float2bfloat16(0.f); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// two neighbouring outputs as one 8-byte (f32) or 4-byte (bf16) store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

struct Geometry {
  int n, h, w, c;   // input shape
  int ct, n_chunk;  // channels per tile (== c when one tile holds them all), tiles along C
  int tw, n_span;   // input pixels per tile, tiles along W
  int tr, n_band;   // input rows per tile, tiles along H
  int rs;           // shared row stride in elements, a multiple of the vector
  int phase;        // x's element offset from 16-byte alignment
  int pairs;        // output pairs (q, q+1) are adjacent and may be stored as one word
  float k0, k1, k2, k3;
};

// Stage rows y0 .. y0 + rows - 1 x pixels [x0, x0 + px) x channels
// [c0, c0 + cte) of one image (img, whose first element sits img_phase
// elements past a 16-byte boundary) in shared memory as T, zero outside the
// image. Row r starts at sm + r * g.rs + ph[r]; pixel j, channel cc of it at
// + j * g.ct + cc (g.ct == c when the tile holds every channel).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ img, int img_phase, const Geometry& g,
                                      int y0, int rows, int x0, int px, int c0, int cte, T* sm,
                                      int* ph) {
  constexpr int V = vec<T>();
  const bool whole = g.ct == g.c;
  const int wc = g.w * g.c;
  const int pieces = g.rs / V;
  // this thread's pieces (row r, piece pc), kThreads pieces apart; the row
  // advances by subtraction rather than division
  int r = threadIdx.x / pieces;
  int pc = threadIdx.x - r * pieces;
  for (; r < rows; ++r, pc -= pieces) {
    const int y = y0 + r;
    const bool in_h = y >= 0 && y < g.h;
    const T* row = img + (int64_t)y * wc;
    const int rowph = img_phase + (int)(((int64_t)y * wc) & (V - 1));
    // a staged row starts at its own misalignment, so that its 16-byte
    // pieces are aligned in both memories
    const int phase = whole && in_h ? (rowph + x0 * g.c) & (V - 1) : 0;
    if (pc == 0) ph[r] = phase;  // by the thread of the row's first piece
    for (; pc < pieces; pc += kThreads) {
      const int s0 = pc * V;
      T* dst = sm + r * g.rs + s0;
      if (!in_h) {
#pragma unroll
        for (int e = 0; e < V; ++e) zero(dst + e);
      } else if (whole) {
        // dst[e] holds row[f0 + e]
        const int f0 = x0 * g.c - phase + s0;
        if (f0 >= 0 && f0 + V <= wc) {
          cp_async16(dst, row + f0);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int f = f0 + e;
            if (f >= 0 && f < wc) dst[e] = row[f];
            else zero(dst + e);
          }
        }
      } else {
        // a piece lies inside one pixel's run of ct channels (ct is a multiple of V)
        const int j = s0 / g.ct;
        const int cc = s0 - j * g.ct;
        const int xp = x0 + j;
        const bool in = j < px && xp >= 0 && xp < g.w;
        const int f0 = xp * g.c + c0 + cc;
        if (in && cc + V <= cte && ((rowph + f0) & (V - 1)) == 0) {
          cp_async16(dst, row + f0);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if (in && cc + e < cte) dst[e] = row[f0 + e];
            else zero(dst + e);
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    blur2x_up_kernel(const T* __restrict__ x, T* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ph[kRows + 2];
  T* sm = reinterpret_cast<T*>(smem);
  // this block's tile: image n, input pixels [v0, v0 + twe), channels
  // [c0, c0 + cte), input rows [u0, u0 + tre)
  const int n = blockIdx.y + blockIdx.z * gridDim.y;
  if (n >= g.n) return;
  int b = blockIdx.x;
  const int span = b % g.n_span;
  b /= g.n_span;
  const int chunk = b % g.n_chunk;
  const int band = b / g.n_chunk;
  const int v0 = span * g.tw, twe = min(g.tw, g.w - v0);
  const int c0 = chunk * g.ct, cte = min(g.ct, g.c - c0);
  const int u0 = band * g.tr, tre = min(g.tr, g.h - u0);
  const int64_t hwc = (int64_t)g.h * g.w * g.c;
  const int img_phase = (int)((g.phase + n * hwc) & (vec<T>() - 1));
  // tile row r is input row u0 - 1 + r; staged pixel j is input pixel v0 - 1 + j
  stage(x + n * hwc, img_phase, g, u0 - 1, tre + 2, v0 - 1, twe + 2, c0, cte, sm, ph);

  // threads over columns of pairs; where a tile row has fewer pairs than
  // threads, over groups of rows too
  const int pairs = twe * cte;  // pairs in a tile row of the output (2 * twe * cte elements)
  int groups = kThreads / pairs;
  groups = groups > 1 ? groups : 1;
  const int per = (tre + groups - 1) / groups;
  const int grp = groups == 1 ? 0 : (int)threadIdx.x / pairs;
  const int first = (int)threadIdx.x - grp * pairs;
  const int step = groups == 1 ? kThreads : pairs;
  const int ua = grp * per;
  const int ub = min(tre, ua + per);
  if (ua >= ub) return;

  T* out_img = out + (int64_t)n * 4 * hwc;
  const int64_t ow = 2 * (int64_t)g.w * g.c;  // output row
  const int pss = g.ct;                       // a pixel's stride in shared memory
  for (int pc = first; pc < pairs; pc += step) {
    // the pair's two outputs: first tap in a staged row (the second is one
    // pixel on), coefficients, place in the output row
    int off[2], col[2];
    float ca[2], cb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 2 * pc + e;
      const int ox = q / cte;  // output pixel in the tile
      const int ch = q - ox * cte;
      const int p = ((ox >> 1) + 1) * pss + ch;  // its input pixel in shared memory
      const bool odd = ox & 1;
      off[e] = odd ? p : p - pss;
      ca[e] = odd ? g.k1 : g.k0;
      cb[e] = odd ? g.k3 : g.k2;
      col[e] = (2 * v0 + ox) * g.c + c0 + ch;
    }
    // horizontal sum of output e in the staged row that starts at r; the
    // loop advances its row pointers by addition
    auto hsum = [&](const T* r, int e) {
      return ca[e] * to_f32(r[off[e]]) + cb[e] * to_f32(r[off[e] + pss]);
    };
    float prev[2], cur[2], next[2];  // sums of input rows u - 1, u, u + 1
    const T* srow = sm + ua * g.rs;  // tile row ua, input row u0 + ua - 1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      prev[e] = hsum(srow + ph[ua], e);
      cur[e] = hsum(srow + g.rs + ph[ua + 1], e);
    }
    srow += 2 * g.rs;
    T* row = out_img + (int64_t)(2 * (u0 + ua)) * ow;  // output row 2u
    for (int u = ua; u < ub; ++u) {
      const T* s = srow + ph[u + 2];
      float even[2], odd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        next[e] = hsum(s, e);
        even[e] = g.k0 * prev[e] + g.k2 * cur[e];  // output row 2u
        odd[e] = g.k1 * cur[e] + g.k3 * next[e];   // output row 2u + 1
        prev[e] = cur[e];
        cur[e] = next[e];
      }
      if (g.pairs) {
        store2(row + col[0], even[0], even[1]);
        store2(row + ow + col[0], odd[0], odd[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          store(row + col[e], even[e]);
          store(row + ow + col[e], odd[e]);
        }
      }
      srow += g.rs;
      row += 2 * ow;
    }
  }
}

// Split `total` into tiles of at most `most`, as even as possible.
void split(int total, int most, int& size, int& count) {
  most = most > 1 ? most : 1;
  count = (total + most - 1) / most;
  size = (total + count - 1) / count;
}

// Tiles of the input: up to kTileElems pixels x channels of a row, up to
// kRows rows, within the shared memory of a block without an opt-in.
// Returns the dynamic shared memory per block, or -1 when the shape exceeds
// the kernel's 32-bit row indexing or the grid.
template <typename T>
int plan(Geometry& g, int n, int h, int w, int c, const void* x, const void* out, const float* k,
         dim3& grid) {
  constexpr int V = vec<T>();
  g.n = n; g.h = h; g.w = w; g.c = c;
  g.k0 = k[0]; g.k1 = k[1]; g.k2 = k[2]; g.k3 = k[3];
  if ((int64_t)2 * w * c > INT32_MAX) return -1;
  g.ct = c <= kMaxChannelTile ? c : kMaxChannelTile;
  g.n_chunk = (c + g.ct - 1) / g.ct;
  split(w, kTileElems / g.ct, g.tw, g.n_span);
  g.rs = ((g.tw + 2) * g.ct + 2 * V - 1) / V * V;  // room for a row's alignment offset
  const int fit = kMaxSmem / (g.rs * (int)sizeof(T)) - 2;  // rows besides the halo
  split(h, fit < kRows ? fit : kRows, g.tr, g.n_band);
  g.phase = (int)(((uintptr_t)x / sizeof(T)) & (V - 1));
  g.pairs = g.n_chunk == 1 && ((uintptr_t)out % (2 * sizeof(T))) == 0;
  const int64_t blocks = (int64_t)g.n_span * g.n_chunk * g.n_band;
  const int ny = n < 65535 ? n : 65535;
  const int nz = (n + ny - 1) / ny;
  if (blocks > INT32_MAX || nz > 65535) return -1;
  grid = dim3((unsigned)blocks, (unsigned)ny, (unsigned)nz);
  return (g.tr + 2) * g.rs * (int)sizeof(T);
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, const float* k, void* stream) {
  if ((int64_t)n * h * w * c == 0) return (int)cudaGetLastError();
  Geometry g;
  dim3 grid;
  const int smem = plan<T>(g, n, h, w, c, x, out, k, grid);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  blur2x_up_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>((const T*)x, (T*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, h, w, c]; out: [n, 2h, 2w, c]; k: the four correlation coefficients
// (host memory)
extern "C" int blur2x_up_f32(const void* x, void* out, int n, int h, int w, int c,
                             const float* k, void* stream) {
  return launch<float>(x, out, n, h, w, c, k, stream);
}

extern "C" int blur2x_up_bf16(const void* x, void* out, int n, int h, int w, int c,
                              const float* k, void* stream) {
  return launch<__nv_bfloat16>(x, out, n, h, w, c, k, stream);
}
