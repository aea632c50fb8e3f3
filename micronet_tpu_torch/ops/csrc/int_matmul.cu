// Int8 matmuls with the activation quantize and the dequantize fused, on Hopper's int8 tensor
// cores (sm_90a).
//
// K1 replaces the TPU kernel micronet_tpu/ops/int_matmul.py::int8_matmul_dequant (Pallas
// body _kernel). It computes what the XLA oracle int8_matmul_dequant_xla computes, for
// x (M, K) f32, w_q (K, N) int8 (row-major), w_scale (N,) f32 and per-tensor s_x, zp:
//
//   q   = clamp(round_half_away(x / s_x) - zp, qmin, qmax)       int8
//   acc = q . w_q + int(zp) * colsum(w_q)                        int32, exact
//   out = f32(acc) * (s_x * w_scale[n])
//
// qmin/qmax are the activation range (narrower than int8 at A4). Every f32 step is the
// oracle's: a true division x / s_x (a reciprocal multiply would move codes that sit on
// a .5 boundary), round half away as floor(|v| + 0.5) with the sign put back, and an
// epilogue of two rounded multiplies (__fmul_rn keeps nvcc from contracting anything
// into an FMA). The bias stays outside the kernel, as in the JAX package.
//
// K2 replaces micronet_tpu/ops/int_matmul.py::binary_act_matmul (Pallas body _sign_kernel):
// the same kernels instantiated with kBinary, whose quantize is the wbwtab sign,
// q = x >= 0 ? +1 : -1 (0 and -0.0 give +1, NaN gives -1), with no zero point, and whose
// epilogue is f32(acc) * alpha[n], one rounded multiply. w_q holds {-1, 0, +1}. Every pad
// (k past K, rows past M, columns past N) holds code 0, never the code of x = 0, which would
// binarize to +1.
//
// Integer sums are exact in any order, so the int32 accumulator does not depend on tiling,
// regime or summation order: both regimes give the twin's bits. The wrapper bounds K so that
// no sum overflows: |q . w| <= K * 128 * 128 < 2^31 for K <= 131,071 (ops/int_matmul.py,
// _K_MAX). The regime comes from M, K, N and the SM count (ops/int_matmul.py::_k1_regime):
//
// Small regime (the engine's fc, M = 512, K = 512, N = 10, and other skinny calls): latency
// bounds it (about 1 MB to move). One launch with the quantize fused: a block owns 16 rows x
// 32 columns (a 1-D tile index, the column tiles of a row tile adjacent); its 8 warps split K
// (warp w takes the k32 steps w, w + 8, ...), each quantizing its own x values into the A
// fragment of mma.sync m16n8k32 s8 and reading B, 4 consecutive k of one column, as one word
// of row-major w_q; K1's colsum by __dp4a on the same words. The warps' partial tiles are
// summed through shared memory, then the epilogue. 32 blocks at the engine's fc.
//
// GEMM regime (large calls): the int8 operations bound it (8192 x 4096 x 4096: 0.139 ms at
// 1,979 TOP/s), or, for K2's 65,536 x 1,024 x 1,024, the f32 bytes of x and out (0.161 ms at
// 3.35 TB/s). Three launches:
// - the codes pre-pass: x quantized (or signed) once into codes (M, Kp) int8, Kp = K rounded
//   up to 16 (TMA's 16-byte strides), pad columns code 0, a warp reading 512 contiguous bytes of
//   x at a time; it also zeroes K1's colsum. Quantizing in the GEMM's own tiles would do it once
//   per 256-column tile (16 times at N = 4,096, 4 at K2's N = 1,024); keeping a row tile's codes
//   for all of K in shared memory, filled by the consumers or by three more warps, was tried and
//   was slower on an H100 (PERF.md §6);
// - the weight pre-pass: w_q (K, N) transposed into wT (N, Kp) int8, K-major (wgmma takes 8-bit
//   operands only K-major), and K1's colsum(w_q) added into colsum by int32 atomics;
// - the GEMM: a persistent, warp-specialised wgmma m64n256k32 s8 x s8 -> s32 kernel, one block
//   an SM walking 128 x 256 tiles of out in bands of 8 row tiles (so the tiles in flight share
//   their codes and wT tiles in L2). One producer warp brings each 128-k stage of codes and wT
//   by TMA (128-byte swizzle) into a ring of 4 slots guarded by full/empty mbarriers, running
//   ahead across tiles; two consumer warpgroups of 64 rows each issue four wgmmas a stage with
//   both operands from shared memory, keeping one stage in flight. TMA fills rows past M and N
//   and k past Kp with zeros. The epilogue turns each thread's 128 int32 into f32 with the
//   twin's steps; where N % 4 == 0 each warp stages 16 x 64 of them in shared memory at a time
//   and stores them by TMA (which clips the edges), so the stores drain while the next tile
//   runs; other N store directly, masked.
// The scratch (codes, wT, colsum) is allocated by the wrapper.

#include "hopper.cuh"  // smem_addr, mbarriers, TMA, wgmma fences and descriptors, encode_tiled
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 131071;  // |q . w| <= K * 128 * 128 fits int32

struct Quant {
  float s, zp, qmin, qmax;
};

__device__ __forceinline__ int quantize(float x, const Quant& qz) {
  const float v = __fdiv_rn(x, qz.s);
  float r = floorf(__fadd_rn(fabsf(v), 0.5f));
  r = v < 0.f ? -r : (v > 0.f ? r : 0.f);  // sign(v) * floor(|v| + 0.5)
  return (int)fminf(fmaxf(__fsub_rn(r, qz.zp), qz.qmin), qz.qmax);
}

template <bool kBinary>
__device__ __forceinline__ uint32_t code(float v, const Quant& qz) {
  return (uint32_t)(kBinary ? (v >= 0.f ? 1 : -1) : quantize(v, qz)) & 0xFFu;
}

template <bool kBinary>
__device__ __forceinline__ Quant load_quant(const float* sx_p, const float* zp_p, float qmin,
                                            float qmax) {
  return kBinary ? Quant{1.f, 0.f, 0.f, 0.f} : Quant{*sx_p, *zp_p, qmin, qmax};
}

// acc + izp * colsum in int32 with wraparound (unsigned: defined), as the twin's int32 sum
__device__ __forceinline__ int add_zp(int acc, int izp, int cs) {
  return (int)((uint32_t)acc + (uint32_t)izp * (uint32_t)cs);
}

// the codes of x[row, k..k+3] as one word, byte i = k + i; 0 past M or K
template <bool kBinary>
__device__ __forceinline__ uint32_t codes4(const float* __restrict__ x, int row, int k, int M,
                                           int K, bool vec, const Quant& qz) {
  if (row >= M) return 0u;
  const float* p = x + (size_t)row * K + k;
  if (vec && k + 4 <= K) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    return code<kBinary>(f.x, qz) | code<kBinary>(f.y, qz) << 8 | code<kBinary>(f.z, qz) << 16 |
           code<kBinary>(f.w, qz) << 24;
  }
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < K) word |= code<kBinary>(__ldg(p + i), qz) << (8 * i);
  return word;
}

// w[k..k+3, col] of row-major (K, N) int8 as one word, byte i = k + i; 0 past K or N
__device__ __forceinline__ uint32_t wcol4(const int8_t* __restrict__ w, int k, int col, int K,
                                          int N) {
  uint32_t word = 0;
  if (col >= N) return word;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < K) word |= (uint32_t)(uint8_t)__ldg(w + (size_t)(k + i) * N + col) << (8 * i);
  return word;
}

// ---------------------------------------------------------------- the small regime

constexpr int kSmRows = 16;                // rows a block: M of m16n8k32
constexpr int kSmCols = 32;                // columns a block: four n8 tiles
constexpr int kSmWarps = 8;                // k slices: warp w takes the k32 steps w, w + 8, ...
constexpr int kSmThreads = 32 * kSmWarps;

// d (16 x 8 s32) += a (16 x 32 s8, row) * b (32 x 8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block t: rows 16 * (t / ntn) .., columns 32 * (t % ntn) .., ntn = ceil(N / 32). Lane (g, q)
// (g = lane / 4, q = lane % 4) builds A rows g and g + 8 at k 4q..4q+3 and 16+4q..16+4q+3 of
// each of its warp's k32 steps and B column g of each n8 tile at the same k.
template <bool kBinary>
__global__ void __launch_bounds__(kSmThreads)
int8_small_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ sx_p,
                  const float* __restrict__ zp_p, float* __restrict__ out, int M, int K, int N,
                  float qmin, float qmax) {
  __shared__ int red[kSmWarps][kSmRows][kSmCols + 1];
  __shared__ int csred[kSmWarps][kSmCols];
  const Quant qz = load_quant<kBinary>(sx_p, zp_p, qmin, qmax);
  const int ntn = (N + kSmCols - 1) / kSmCols;
  const int m0 = blockIdx.x / ntn * kSmRows, n0 = blockIdx.x % ntn * kSmCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  int acc[4][4] = {};
  int cs[4] = {};
  const int steps = (K + 31) / 32;
#pragma unroll 2
  for (int s = warp; s < steps; s += kSmWarps) {
    const int k = 32 * s + 4 * q;
    const uint32_t a[4] = {codes4<kBinary>(x, m0 + g, k, M, K, vec, qz),
                           codes4<kBinary>(x, m0 + g + 8, k, M, K, vec, qz),
                           codes4<kBinary>(x, m0 + g, k + 16, M, K, vec, qz),
                           codes4<kBinary>(x, m0 + g + 8, k + 16, M, K, vec, qz)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b0 = wcol4(w, k, n0 + 8 * j + g, K, N);
      const uint32_t b1 = wcol4(w, k + 16, n0 + 8 * j + g, K, N);
      mma_s8(acc[j], a, b0, b1);
      if (!kBinary) cs[j] = __dp4a((int)b1, 0x01010101, __dp4a((int)b0, 0x01010101, cs[j]));
    }
  }
  // acc[j][e]: row g + 8 * (e / 2), column 8j + 2q + e % 2; cs[j]: column 8j + g, this lane's k
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][g + 8 * (e >> 1)][8 * j + 2 * q + (e & 1)] = acc[j][e];
    if (!kBinary) {
      int c = cs[j];
      c += __shfl_xor_sync(0xFFFFFFFFu, c, 1);
      c += __shfl_xor_sync(0xFFFFFFFFu, c, 2);
      if (q == 0) csred[warp][8 * j + g] = c;
    }
  }
  __syncthreads();
  const int izp = (int)qz.zp;  // truncation, as the oracle's astype(int32)
  for (int e = threadIdx.x; e < kSmRows * kSmCols; e += kSmThreads) {
    const int r = e / kSmCols, c = e % kSmCols, gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    int a = 0, cc = 0;
#pragma unroll
    for (int v = 0; v < kSmWarps; ++v) {
      a += red[v][r][c];
      if (!kBinary) cc += csred[v][c];
    }
    out[(size_t)gm * N + gn] =
        kBinary ? __fmul_rn(__int2float_rn(a), scale[gn])
                : __fmul_rn(__int2float_rn(add_zp(a, izp, cc)), __fmul_rn(qz.s, scale[gn]));
  }
}

// ---------------------------------------------------------------- the GEMM regime: pre-passes

constexpr int kPreThreads = 256;
constexpr int kPreMaxBlocks = 8192;

// x (M, K) f32 -> codes (M, Kp) int8, pad columns 0. Thread i writes the 4 codes of unit i;
// units run along the rows, so a warp reads 512 contiguous bytes of x and writes 128 of codes.
// K1's colsum (N,) is zeroed here, for the weight pass after it. M * Kp / 4 < 2^31.
template <bool kBinary>
__global__ void __launch_bounds__(kPreThreads)
int8_codes_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                  int* __restrict__ colsum, const float* __restrict__ sx_p,
                  const float* __restrict__ zp_p, int M, int K, int Kp, int N, float qmin,
                  float qmax) {
  const Quant qz = load_quant<kBinary>(sx_p, zp_p, qmin, qmax);
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int upr = Kp / 4, total = M * upr;
  const int stride = gridDim.x * blockDim.x, first = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kBinary)
    for (int i = first; i < N; i += stride) colsum[i] = 0;
#pragma unroll 4
  for (int i = first; i < total; i += stride) {
    const int row = i / upr, k = (i - row * upr) * 4;
    *reinterpret_cast<uint32_t*>(codes + (size_t)row * Kp + k) =
        codes4<kBinary>(x, row, k, M, K, vec, qz);
  }
}

constexpr int kWtTile = 64;  // a block transposes 64 k x 64 columns

// w (K, N) int8 -> wT (N, Kp) int8, pad columns 0; K1 adds colsum(w) into colsum (int32
// atomics: exact in any order). Block t: k tile t / ntn, column tile t % ntn.
template <bool kColsum>
__global__ void __launch_bounds__(kPreThreads)
int8_wt_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int* __restrict__ colsum,
               int K, int Kp, int N) {
  __shared__ __align__(16) int8_t tile[kWtTile][kWtTile + 16];
  const int ntn = (N + kWtTile - 1) / kWtTile;
  const int k0 = blockIdx.x / ntn * kWtTile, n0 = blockIdx.x % ntn * kWtTile;
  const int t = threadIdx.x, r = t >> 2, c = (t & 3) * 16;  // 64 rows x 4 chunks of 16
  const bool vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  // rows k0 + r of w, columns n0 + c ..
  if (vec && k0 + r < K && n0 + c < N) {
    *reinterpret_cast<uint4*>(&tile[r][c]) =
        __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      tile[r][c + i] = (k0 + r < K && n0 + c + i < N) ? w[(size_t)(k0 + r) * N + n0 + c + i] : 0;
  }
  __syncthreads();
  // row n0 + r of wT, k0 + c ..
  uint32_t word[4];
  int sum = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    word[b] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t v = tile[c + 4 * b + i][r];
      word[b] |= (uint32_t)(uint8_t)v << (8 * i);
      sum += v;
    }
  }
  if (n0 + r < N && k0 + c < Kp)
    *reinterpret_cast<uint4*>(wt + (size_t)(n0 + r) * Kp + k0 + c) =
        make_uint4(word[0], word[1], word[2], word[3]);
  if (kColsum) {  // the four threads of a row are adjacent lanes
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
    if ((t & 3) == 0 && n0 + r < N) atomicAdd(colsum + n0 + r, sum);
  }
}

// ---------------------------------------------------------------- the GEMM regime: wgmma

constexpr int kGmM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int kGmN = 256;       // columns a tile: N of m64n256k32
constexpr int kGmK = 128;       // k a stage: one 128-byte swizzle row, four k32 steps
constexpr int kGmRaster = 8;    // row tiles in a band of the tile order
constexpr int kGmABytes = kGmM * kGmK;  // a stage's codes tile, [row][128 bytes]
constexpr int kGmBBytes = kGmN * kGmK;  // its wT tile, [column][128 bytes]
constexpr int kGmSlot = kGmABytes + kGmBBytes;
static_assert(kGmSlot % 1024 == 0, "slots must keep the swizzle's 1024-byte alignment");
constexpr int kGmStages = 4;    // ring slots
// the epilogue: each warp stages 16 rows x 64 columns of f32 out (two 128-byte swizzled boxes of
// 32 columns) for TMA stores
constexpr int kGmOutBox = 32;                    // columns a TMA store box (128 bytes)
constexpr int kGmOutChunk = 16 * 64 * 4;         // a chunk's staging bytes
constexpr int kGmConsumers = 2 * 128;
constexpr int kGmThreads = kGmConsumers + 32;    // and one producer warp
constexpr int kGmSmem = 1024 + kGmStages * kGmSlot + kGmConsumers / 32 * kGmOutChunk +
                        2 * kGmStages * 8;       // + alignment and the barriers
static_assert(kGmSmem <= 232448, "the GEMM's shared memory exceeds a block's");

// d (64 x 256 s32, 128 a thread) += A (64 x 32 s8) * B (32 x 256 s8), both K-major with the
// 128-byte swizzle, from shared memory through their descriptors; wraps on overflow like any
// int32 sum (the wrapper bounds K so that it never does)
__device__ __forceinline__ void wgmma_s8_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// a 2-D TMA tile store from this CTA's shared memory, in the thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// f32 out of acc[4j + e] (row g + 8 * (e / 2) of the warp's 16, column 8j + 2q + e % 2 of the
// tile) with the twin's steps: K1 f32(acc + izp * colsum) * (s_x * w_scale), K2 f32(acc) * alpha
template <bool kBinary>
__device__ __forceinline__ float2 dequant2(const int (&acc)[128], int i, const float2 sc,
                                           const int2 cs, int izp) {
  const int a0 = acc[i], a1 = acc[i + 1];
  return make_float2(__fmul_rn(__int2float_rn(kBinary ? a0 : add_zp(a0, izp, cs.x)), sc.x),
                     __fmul_rn(__int2float_rn(kBinary ? a1 : add_zp(a1, izp, cs.y)), sc.y));
}

// the column scales (and K1's colsum) of columns n, n + 1 (n + 1 < N, or a copy of n's)
template <bool kBinary>
__device__ __forceinline__ void column_terms(const float* __restrict__ scale,
                                             const int* __restrict__ colsum, float s_x, int n,
                                             int N, float2& sc, int2& cs) {
  const int n1 = n + 1 < N ? n + 1 : n;
  sc = kBinary ? make_float2(scale[n], scale[n1])
               : make_float2(__fmul_rn(s_x, scale[n]), __fmul_rn(s_x, scale[n1]));
  cs = kBinary ? make_int2(0, 0) : make_int2(colsum[n], colsum[n1]);
}

// The epilogue of one tile, by the warp that owns rows row0..row0+15 of it. kTmaStore (N % 4 ==
// 0, so out's rows are 16-byte strides): per 64 columns, the warp writes its values into its
// staging (the 128-byte swizzle: 16-byte chunk c of row r at c ^ (r % 8)) and lane 0 stores them
// with two TMA box stores, which clip rows past M and columns past N; the staging is reused once
// the previous stores have read it. Else plain stores, masked.
template <bool kBinary, bool kTmaStore>
__device__ __forceinline__ void store_tile(const int (&acc)[128], const float* __restrict__ scale,
                                           const int* __restrict__ colsum, const Quant& qz,
                                           const CUtensorMap* omap, uint8_t* staging,
                                           float* __restrict__ out, int row0, int n0, int lane,
                                           int M, int N) {
  const int g = lane >> 2, q = lane & 3, izp = (int)qz.zp;
  if (kTmaStore) {
    if (row0 >= M) return;
#pragma unroll
    for (int ch = 0; ch < kGmN / 64; ++ch) {
      if (n0 + 64 * ch >= N) break;
      if (lane == 0) bulk_wait_read();  // the staging is free again
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {  // columns 64ch + 8jj + 2q, + 1
        const int j = 8 * ch + jj, n = n0 + 8 * j + 2 * q;
        float2 sc = make_float2(0.f, 0.f);
        int2 cs = make_int2(0, 0);
        if (n < N) column_terms<kBinary>(scale, colsum, qz.s, n, N, sc, cs);
        const int box = jj >> 2, chunk = 2 * (jj & 3) + (q >> 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          *reinterpret_cast<float2*>(staging + box * 2048 + r * 128 + ((chunk ^ (r & 7)) << 4) +
                                     (q & 1) * 8) = dequant2<kBinary>(acc, 4 * j + 2 * h, sc, cs,
                                                                      izp);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA
      __syncwarp();
      if (lane == 0) {
        tma_store(omap, staging, n0 + 64 * ch, row0);
        tma_store(omap, staging + 2048, n0 + 64 * ch + kGmOutBox, row0);
        bulk_commit();
      }
    }
    return;
  }
  const bool pair = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < kGmN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * q;
    if (n >= N) continue;
    float2 sc;
    int2 cs;
    column_terms<kBinary>(scale, colsum, qz.s, n, N, sc, cs);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + g + 8 * h;
      if (m >= M) continue;
      const float2 v = dequant2<kBinary>(acc, 4 * j + 2 * h, sc, cs, izp);
      float* o = out + (size_t)m * N + n;
      if (pair) {
        *reinterpret_cast<float2*>(o) = v;
      } else {
        o[0] = v.x;
        if (n + 1 < N) o[1] = v.y;
      }
    }
  }
}

// A persistent block (one an SM) walks the 128 x 256 tiles of out blockIdx.x, + gridDim.x, ...,
// numbered in bands of kGmRaster row tiles (column tiles across a band), so the tiles in flight
// share their codes and wT tiles in L2. Warps 0-7 are two consumer warpgroups (warpgroup c: rows
// m0 + 64c ..), warp 8 the producer: lane 0 issues the TMA loads of codes and wT, 128 k a stage,
// running up to the ring ahead across tiles, so one tile's epilogue overlaps the next tile's
// loads. Slot s is guarded by full[s] (lane 0's expect_tx arrival and the bytes) and empty[s]
// (an arrival from every consumer thread once its wgmmas on the slot are done).
template <bool kBinary, bool kTmaStore>
__global__ void __launch_bounds__(kGmThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap omap, const float* __restrict__ scale,
                 const int* __restrict__ colsum, const float* __restrict__ sx_p,
                 const float* __restrict__ zp_p, float* __restrict__ out, int M, int Kp, int N) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + kGmStages * kGmSlot;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kGmConsumers / 32 * kGmOutChunk);
  uint64_t* empty = full + kGmStages;
  const int num_m = (M + kGmM - 1) / kGmM, num_n = (N + kGmN - 1) / kGmN;
  const int tiles = num_m * num_n;
  const int nk = (Kp + kGmK - 1) / kGmK;
  auto origin = [&](int tile, int& m0, int& n0) {
    const int band = tile / (kGmRaster * num_n);
    const int first_m = band * kGmRaster;
    const int band_m = min(num_m - first_m, kGmRaster);
    const int in_band = tile % (kGmRaster * num_n);
    m0 = (first_m + in_band % band_m) * kGmM;
    n0 = in_band / band_m * kGmN;
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kGmStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kGmConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kGmConsumers / 32) {  // the producer warp
    if (lane == 0) {
      int v = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        origin(tile, m0, n0);
        for (int kb = 0; kb < nk; ++kb, ++v) {
          const int slot_i = v % kGmStages;
          if (v >= kGmStages) mbar_wait(empty + slot_i, (v / kGmStages - 1) & 1);
          uint8_t* slot = ring + slot_i * kGmSlot;
          mbar_expect_tx(full + slot_i, kGmSlot);  // zeros past the edges arrive too
          tma_load(slot, &amap, full + slot_i, kGmK * kb, m0);
          tma_load(slot + kGmABytes, &bmap, full + slot_i, kGmK * kb, n0);
        }
      }
    }
    return;
  }

  const Quant qz = load_quant<kBinary>(sx_p, zp_p, 0.f, 0.f);
  const int wg = warp >> 2;
  uint8_t* my_staging = staging + warp * kGmOutChunk;
  int acc[128];
  int v = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    origin(tile, m0, n0);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    for (int kb = 0; kb < nk; ++kb, ++v) {
      const int slot_i = v % kGmStages;
      const uint32_t a = smem_addr(ring + slot_i * kGmSlot) + wg * 64 * kGmK;
      const uint32_t b = smem_addr(ring + slot_i * kGmSlot + kGmABytes);
      mbar_wait(full + slot_i, (v / kGmStages) & 1);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kGmK / 32; ++i)
        wgmma_s8_m64n256k32(acc, sw128_desc(a + 32 * i), sw128_desc(b + 32 * i));
      wgmma_commit();
      reg_fence(acc);
      wgmma_wait<1>();  // the stage before is done: its slot goes back to the producer
      reg_fence(acc);
      if (kb > 0) mbar_arrive(empty + (v - 1) % kGmStages);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty + (v - 1) % kGmStages);  // the tile's last stage
    store_tile<kBinary, kTmaStore>(acc, scale, colsum, qz, &omap, my_staging, out,
                                   m0 + 64 * wg + 16 * (warp & 3), n0, lane, M, N);
  }
  if (kTmaStore && lane == 0) bulk_wait_all();  // before the block's shared memory goes
}

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && sms[dev]) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) sms[dev] = n;
  return n;
}

// the tensor maps of codes (M, Kp) and wT (N, Kp), int8, boxes of 128 k x 128 rows and 128 k x
// 256 columns with the 128-byte swizzle (zeros past the edges), and of out (M, N) f32 (where N %
// 4 == 0), boxes of 32 columns x 16 rows with the same swizzle; then the GEMM on min(tiles, SMs)
// blocks
template <bool kBinary, bool kTmaStore>
int gemm_launch(const int8_t* codes, const int8_t* wt, const float* scale, const int* colsum,
                const float* sx, const float* zp, float* out, int M, int Kp, int N,
                cudaStream_t st) {
  EncodeTiled encode = encode_tiled();
  const int sms = sm_count();
  if (encode == nullptr || sms == 0) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[2] = {1, 1};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint64_t adims[2] = {(cuuint64_t)Kp, (cuuint64_t)M};
  const cuuint64_t bdims[2] = {(cuuint64_t)Kp, (cuuint64_t)N};
  const cuuint32_t abox[2] = {kGmK, kGmM};
  const cuuint32_t bbox[2] = {kGmK, kGmN};
  const cuuint64_t odims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t ostrides[1] = {(cuuint64_t)N * 4};
  const cuuint32_t obox[2] = {kGmOutBox, 16};
  CUtensorMap amap, bmap, omap;
  if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(codes), adims, strides,
             abox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS ||
      encode(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(wt), bdims, strides,
             bbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  omap = amap;  // unused without kTmaStore
  if (kTmaStore &&
      encode(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, odims, ostrides, obox, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kern = int8_gemm_kernel<kBinary, kTmaStore>;
  static bool allowed[64] = {};
  cudaError_t e = allow_smem(kern, kGmSmem, allowed);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((M + kGmM - 1) / kGmM) * ((N + kGmN - 1) / kGmN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, kGmThreads, kGmSmem, st>>>(amap, bmap, omap, scale, colsum, sx, zp, out, M, Kp, N);
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int K, int N) { return M <= 0 || K <= 0 || N <= 0 || K > kMaxK; }

template <bool kBinary>
int small_call(const void* x, const void* w, const void* scale, const void* sx, const void* zp,
               void* out, int M, int K, int N, float qmin, float qmax, void* stream) {
  const long long blocks =
      (long long)((M + kSmRows - 1) / kSmRows) * ((N + kSmCols - 1) / kSmCols);
  if (bad_shape(M, K, N) || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int8_small_kernel<kBinary><<<(unsigned)blocks, kSmThreads, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(sx),
      static_cast<const float*>(zp), static_cast<float*>(out), M, K, N, qmin, qmax);
  return (int)cudaGetLastError();
}

// the codes pre-pass, the weight pre-pass, the GEMM
template <bool kBinary>
int gemm_call(const void* x, const void* w, const void* scale, const void* sx, const void* zp,
              void* out, void* codes, void* wt, void* colsum, int M, int K, int N, float qmin,
              float qmax, void* stream) {
  const int Kp = (K + 15) / 16 * 16;
  const long long units = (long long)M * (Kp / 4);
  const long long wt_blocks =
      (long long)((Kp + kWtTile - 1) / kWtTile) * ((N + kWtTile - 1) / kWtTile);
  if (bad_shape(M, K, N) || units > 0x7FFFFFFF || wt_blocks > 0x7FFFFFFF || codes == nullptr ||
      wt == nullptr || (!kBinary && colsum == nullptr) ||
      reinterpret_cast<uintptr_t>(codes) % 16 || reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  int8_t* t = static_cast<int8_t*>(wt);
  int* cs = static_cast<int*>(colsum);
  const float* sxf = static_cast<const float*>(sx);
  const float* zpf = static_cast<const float*>(zp);
  const long long want = (units + kPreThreads - 1) / kPreThreads;
  const int blocks = (int)(want < kPreMaxBlocks ? want : kPreMaxBlocks);
  int8_codes_kernel<kBinary><<<blocks, kPreThreads, 0, st>>>(
      static_cast<const float*>(x), c, cs, sxf, zpf, M, K, Kp, N, qmin, qmax);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int8_wt_kernel<!kBinary><<<(unsigned)wt_blocks, kPreThreads, 0, st>>>(
      static_cast<const int8_t*>(w), t, cs, K, Kp, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  return N % 4 == 0 ? gemm_launch<kBinary, true>(c, t, sc, cs, sxf, zpf, o, M, Kp, N, st)
                    : gemm_launch<kBinary, false>(c, t, sc, cs, sxf, zpf, o, M, Kp, N, st);
}

}  // namespace

// K1, small regime (ops/int_matmul.py::_k1_regime): x (M, K) f32, w_q (K, N) int8, w_scale
// (N,) f32, s_x and zp one f32 each (device pointers), out (M, N) f32. One launch. Returns
// cudaGetLastError() after it.
extern "C" int mn_int8_matmul_dequant_small(const void* x, const void* w_q, const void* w_scale,
                                            const void* s_x, const void* zp, void* out, int M,
                                            int K, int N, float qmin, float qmax, void* stream) {
  return small_call<false>(x, w_q, w_scale, s_x, zp, out, M, K, N, qmin, qmax, stream);
}

// K1, GEMM regime: as the small regime (out 16-byte aligned), with the scratch codes (M, Kp)
// int8, wT (N, Kp) int8 (both 16-byte aligned) and colsum (N,) int32, Kp = K rounded up to 16.
// Three launches: the codes pre-pass, the weight pre-pass, the GEMM.
extern "C" int mn_int8_matmul_dequant_gemm(const void* x, const void* w_q, const void* w_scale,
                                           const void* s_x, const void* zp, void* out,
                                           void* codes, void* wt, void* colsum, int M, int K,
                                           int N, float qmin, float qmax, void* stream) {
  return gemm_call<false>(x, w_q, w_scale, s_x, zp, out, codes, wt, colsum, M, K, N, qmin, qmax,
                          stream);
}

// K2, small regime: x (M, K) f32, w_q (K, N) int8 in {-1, 0, +1}, alpha (N,) f32, out (M, N)
// f32. One launch.
extern "C" int mn_binary_act_matmul_small(const void* x, const void* w_q, const void* alpha,
                                          void* out, int M, int K, int N, void* stream) {
  return small_call<true>(x, w_q, alpha, nullptr, nullptr, out, M, K, N, 0.f, 0.f, stream);
}

// K2, GEMM regime: as the small regime, with the scratch codes (M, Kp) and wT (N, Kp) int8.
// Three launches.
extern "C" int mn_binary_act_matmul_gemm(const void* x, const void* w_q, const void* alpha,
                                         void* out, void* codes, void* wt, int M, int K, int N,
                                         void* stream) {
  return gemm_call<true>(x, w_q, alpha, nullptr, nullptr, out, codes, wt, nullptr, M, K, N, 0.f,
                         0.f, stream);
}
