// The integer engine's data movement in front of its GEMMs, in one pass an operand (sm_90a):
// the patch matrix of a conv and the channel shuffle, both over int8 codes in NHWC memory.
//
// It replaces no TPU kernel. The JAX package leaves its convolutions to XLA
// (micronet_tpu/infer/engine.py runs lax.conv_general_dilated, and its channel shuffle is a
// gather by a permutation), so no Pallas kernel does this work there. PyTorch ran it as
// generic strided copies, one int8 element a thread: a padded copy of the input, then the
// unfold's permute and reshape for a k x k conv; for a shuffle a reshape and transpose into
// NCHW memory, which the next conv then copied back to NHWC. These kernels read each input
// once and write what the next operation reads once, with the twin's bytes
// (ops/patch_gather.py::patch_matrix_ref and patch_shuffle_ref).
//
// Bytes bound them: no arithmetic but index math and, in the f32 variant, one product an
// element (NIN-GC W4A4 at batch 1,024 moves 2.74 GB a forward through them: 0.82 ms at
// 3.35 TB/s). So the design is about keeping bytes in flight and the index math off the
// critical path; no tensor cores, TMA or clusters:
// - patch_matrix_kernel<Out, V>: out (M, K) row-major, K = kh * kw * C in (kh, kw, c) order,
//   row m = (n, oy, ox). A row is kh * kw segments of C bytes, each copied from one input
//   pixel or zero-filled (padding). A thread owns one V-byte chunk of a row's columns (V = 16
//   where C % 16 == 0 and both bases are 16-byte aligned, else 4, else 1) and keeps it for
//   its whole walk down the rows: the grid's thread count is a multiple of K / V (the
//   wrapper's grid), so its tap, channel and offsets are worked out once and each row costs
//   two divisions and a bounds test. A persistent grid of one wave (as many blocks as the SMs
//   hold at once, rounded down to that multiple: a second wave would run a whole block's
//   share of rows alone after the first) walks rows in steps of kUnroll, whose loads are all
//   issued before any is stored; a warp's stores are contiguous. Neighbouring rows read the
//   same input pixels (a 3 x 3 conv reads each nine times), and the rows in flight at once
//   span a few images, so those reads hit L2.
//   The f32 variant (the first layer's dequantized patches, C = 3) writes
//   __fmul_rn(float(code), scale), the twin's single f32 product, padding +0.0f; a thread
//   makes 4 consecutive columns of a row, each from its own tap, since a division per
//   4-byte output made a kernel bound by its instructions.
// - patch_shuffle_kernel<kTile>: out[p][k * g + r] = x[p][r * (C / g) + k] for each pixel
//   row p. With kTile (C % 16 == 0, 16-byte aligned bases, C <= kTileBytes) a block stages a
//   tile of whole pixel rows in shared memory with 16-byte loads, then each thread builds 16
//   output bytes from it (the source offset stepped by C / g, wrapped back by C - 1 at each
//   group's end: no division a byte) and writes them as one 16-byte store. Without it, one
//   output byte a thread, each thread keeping its output channel (so its source offset) for
//   its whole walk down the pixels. The groups come in as an integer: no index tensor.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTileBytes = 16384;
constexpr int kF32Columns = 4;  // the f32 variant's columns a thread

template <int V>
struct Chunk;
template <>
struct Chunk<16> {
  using T = uint4;
};
template <>
struct Chunk<4> {
  using T = uint32_t;
};
template <>
struct Chunk<1> {
  using T = uint8_t;
};

struct MatrixParams {
  const int8_t* x;     // (N, H, W, C) contiguous codes
  void* out;           // (M, K) contiguous: int8 codes, or f32 with a scale
  const float* scale;  // 0-dim f32 (the f32 variant only)
  int h, w, c, ho, wo, kw, sh, sw, ph, pw, dh, dw;
  int m;    // N * Ho * Wo rows
  int k;    // columns a row: kh * kw * C
  int cpr;  // chunks a row: K / V, rounded up
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint32_t zero<uint32_t>() {
  return 0u;
}
template <>
__device__ __forceinline__ uint8_t zero<uint8_t>() {
  return 0u;
}

// int8 codes: a thread copies one V-byte chunk of a row (one tap's channels ci..ci+V-1).
template <int V>
__device__ __forceinline__ void copy_chunks(const MatrixParams& p) {
  using T = typename Chunk<V>::T;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int col = first % p.cpr;
  const int rows = gridDim.x * kThreads / p.cpr;  // the grid's threads are a multiple of cpr
  const int off = col * V;                        // the chunk's first column of a row
  const int tap = off / p.c;
  const int ci = off - tap * p.c;
  const int ki = tap / p.kw;
  const int kj = tap - ki * p.kw;
  const int dy = ki * p.dh - p.ph;
  const int dx = kj * p.dw - p.pw;
  const int hw = p.ho * p.wo;
  for (int r = first / p.cpr; r < p.m; r += rows * kUnroll) {
    T a[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rk = r + k * rows;
      a[k] = zero<T>();
      if (rk < p.m) {
        const int n = rk / hw;
        const int rem = rk - n * hw;
        const int oy = rem / p.wo;
        const int iy = oy * p.sh + dy;
        const int ix = (rem - oy * p.wo) * p.sw + dx;
        if ((unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w) {
          const long long at = (((long long)n * p.h + iy) * p.w + ix) * p.c + ci;
          a[k] = __ldg(reinterpret_cast<const T*>(p.x + at));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rk = r + k * rows;
      if (rk >= p.m) break;
      static_cast<T*>(p.out)[(long long)rk * p.cpr + col] = a[k];
    }
  }
}

// The f32 variant: a thread makes V consecutive columns of a row (the last chunk of a row may
// hold fewer: K = 75 or 27 is kept, so rows are not 16-byte aligned and the stores are
// scalar), each from its own tap, so the row's two divisions serve V outputs.
template <int V>
__device__ __forceinline__ void dequant_columns(const MatrixParams& p) {
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int col = first % p.cpr;
  const int rows = gridDim.x * kThreads / p.cpr;
  const int hw = p.ho * p.wo;
  const float s = *p.scale;
  int dy[V], dx[V], delta[V];
  bool valid[V];
#pragma unroll
  for (int g = 0; g < V; ++g) {
    const int j = col * V + g;
    valid[g] = j < p.k;
    const int tap = j / p.c;
    const int ci = j - tap * p.c;
    const int ki = tap / p.kw;
    const int kj = tap - ki * p.kw;
    dy[g] = ki * p.dh - p.ph;
    dx[g] = kj * p.dw - p.pw;
    delta[g] = (dy[g] * p.w + dx[g]) * p.c + ci;  // from the window's corner pixel
  }
  for (int r = first / p.cpr; r < p.m; r += rows) {
    const int n = r / hw;
    const int rem = r - n * hw;
    const int oy = rem / p.wo;
    const int y0 = oy * p.sh;
    const int x0 = (rem - oy * p.wo) * p.sw;
    const long long corner = (((long long)n * p.h + y0) * p.w + x0) * p.c;
    float v[V];
#pragma unroll
    for (int g = 0; g < V; ++g) {
      const int iy = y0 + dy[g];
      const int ix = x0 + dx[g];
      const bool in = valid[g] && (unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w;
      v[g] = in ? __fmul_rn((float)__ldg(p.x + corner + delta[g]), s) : 0.f;
    }
    float* out = static_cast<float*>(p.out) + (long long)r * p.k + col * V;
#pragma unroll
    for (int g = 0; g < V; ++g) {
      if (valid[g]) out[g] = v[g];
    }
  }
}

// Out int8_t: V-byte chunks of codes. Out float: the f32 variant, V columns a thread.
template <typename Out, int V>
__global__ void __launch_bounds__(kThreads) patch_matrix_kernel(MatrixParams p) {
  if constexpr (std::is_same<Out, float>::value) {
    dequant_columns<V>(p);
  } else {
    copy_chunks<V>(p);
  }
}

struct ShuffleParams {
  const int8_t* x;  // (P, C) contiguous: NHWC pixel rows
  int8_t* out;      // (P, C) contiguous
  long long pixels;
  int c, g;
};

template <bool kTile>
__global__ void __launch_bounds__(kThreads) patch_shuffle_kernel(ShuffleParams p) {
  const int cg = p.c / p.g;
  if constexpr (kTile) {
    __shared__ uint4 tile[kTileBytes / 16];
    const uint8_t* t8 = reinterpret_cast<const uint8_t*>(tile);
    const int per = kTileBytes / p.c;  // pixels a tile
    const int chunks_px = p.c / 16;
    const long long tiles = (p.pixels + per - 1) / per;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long p0 = t * per;
      const int np = (int)min((long long)per, p.pixels - p0);
      const int chunks = np * chunks_px;
      const uint4* src = reinterpret_cast<const uint4*>(p.x + p0 * p.c);
      uint4* dst = reinterpret_cast<uint4*>(p.out + p0 * p.c);
      __syncthreads();  // the last tile's reads are done
      for (int q = threadIdx.x; q < chunks; q += kThreads) tile[q] = __ldg(src + q);
      __syncthreads();
      for (int q = threadIdx.x; q < chunks; q += kThreads) {
        const int px = q / chunks_px;
        const int j0 = (q - px * chunks_px) * 16;
        int k = j0 / p.g;
        int r = j0 - k * p.g;
        int at = px * p.c + r * cg + k;  // the source byte of output byte j0
        uint32_t w[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          uint32_t v = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v |= (uint32_t)t8[at] << (8 * i);
            // the next output byte: r + 1, or r = 0 and k + 1 at the group's end
            const bool wrap = ++r == p.g;
            r = wrap ? 0 : r;
            at += wrap ? 1 - (p.g - 1) * cg : cg;
          }
          w[b] = v;
        }
        dst[q] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  } else {
    // the grid's threads are a multiple of C: each keeps its output channel j
    const int first = blockIdx.x * kThreads + threadIdx.x;
    const int j = first % p.c;
    const long long step = (long long)gridDim.x * kThreads / p.c;
    const int from = (j % p.g) * cg + j / p.g;
    for (long long px = first / p.c; px < p.pixels; px += step) {
      p.out[px * p.c + j] = __ldg(p.x + px * p.c + from);
    }
  }
}

}  // namespace

// x (N, H, W, C) int8 contiguous; out (N * Ho * Wo, K = kh * kw * C) contiguous, int8 codes,
// or f32 code * scale when `scale` (0-dim f32) is not null (then vec must be 4, the columns a
// thread). `vec` is otherwise the chunk in bytes, 16, 4 or 1 (C % vec == 0 and both bases
// vec-byte aligned: the wrapper checks); `blocks` the grid, a multiple of cpr / gcd(cpr, 256)
// blocks for the cpr = ceil(K / vec) chunks of a row (one wave of mn_patch_blocks_per_sm's
// where it can be). One launch.
extern "C" int mn_patch_matrix(const void* x, void* out, const void* scale, int n, int h, int w,
                               int c, int ho, int wo, int kh, int kw, int sh, int sw, int ph,
                               int pw, int dh, int dw, int vec, int blocks, void* stream) {
  const MatrixParams p{static_cast<const int8_t*>(x), out, static_cast<const float*>(scale),
                       h, w, c, ho, wo, kw, sh, sw, ph, pw, dh, dw, n * ho * wo, kh * kw * c,
                       (kh * kw * c + vec - 1) / vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale != nullptr) {
    patch_matrix_kernel<float, kF32Columns><<<blocks, kThreads, 0, s>>>(p);
  } else if (vec == 16) {
    patch_matrix_kernel<int8_t, 16><<<blocks, kThreads, 0, s>>>(p);
  } else if (vec == 4) {
    patch_matrix_kernel<int8_t, 4><<<blocks, kThreads, 0, s>>>(p);
  } else {
    patch_matrix_kernel<int8_t, 1><<<blocks, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// The blocks of the kernel `variant` an SM can hold at once (into *blocks): variant 16, 4 or 1
// the int8 patch kernel of that chunk, 0 its f32 variant, 2 and 3 the shuffle's per-byte and
// tiled kernels. The wrapper sizes its persistent grids to one wave of them.
extern "C" int mn_patch_blocks_per_sm(int variant, int* blocks) {
  cudaError_t e = cudaErrorInvalidValue;
  switch (variant) {
    case 16:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, patch_matrix_kernel<int8_t, 16>,
                                                        kThreads, 0);
      break;
    case 4:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, patch_matrix_kernel<int8_t, 4>,
                                                        kThreads, 0);
      break;
    case 1:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, patch_matrix_kernel<int8_t, 1>,
                                                        kThreads, 0);
      break;
    case 0:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, patch_matrix_kernel<float, kF32Columns>, kThreads, 0);
      break;
    case 2:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, patch_shuffle_kernel<false>,
                                                        kThreads, 0);
      break;
    case 3:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, patch_shuffle_kernel<true>,
                                                        kThreads, 0);
      break;
  }
  return (int)e;
}

// x, out (pixels, C) int8 contiguous; g divides C. `tiled` picks the shared-memory kernel (C %
// 16 == 0, C <= 16,384, both bases 16-byte aligned: the wrapper checks), whose grid is any;
// the other's `blocks` is a multiple of C / gcd(C, 256). One launch.
extern "C" int mn_patch_shuffle(const void* x, void* out, long long pixels, int c, int g,
                                int tiled, int blocks, void* stream) {
  const ShuffleParams p{static_cast<const int8_t*>(x), static_cast<int8_t*>(out), pixels, c, g};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled) {
    patch_shuffle_kernel<true><<<blocks, kThreads, 0, s>>>(p);
  } else {
    patch_shuffle_kernel<false><<<blocks, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
