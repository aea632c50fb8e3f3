// W4A16 matmuls over packed int4 weights, for Hopper (sm_90a).
//
// K3 replaces the TPU kernel micronet_tpu/ops/int4_matmul.py::int4_matmul_grouped_hl8
// (Pallas body _kernel_grouped_hl8). It computes what the XLA oracle
// int4_matmul_grouped_hl8_xla computes:
//
//   out[m, n] = sum_g  scale[g, n] * sum_{k in group g} bf16(x[m, k]) * q[k, n]
//
// with f32 accumulation. Layout (the JAX package's, kept as is): packed row r of
// the (K/2, N) int8 array holds weight row r in its low nibble and row K/2 + r in
// its high nibble, stored as the hl8 byte b = 16*q_hi + (q_lo + 8). Packed group
// gi (rows gi*g .. gi*g+g-1) feeds scale row gi (low half) and g1 + gi (high half),
// g1 = (K/2)/g. The v5e three-dot identity and float-floor unpack are not carried
// over: Hopper unpacks with integer ops, q_hi = b >> 4 (arithmetic shift) and
// q_lo = (b & 0xF) - 8.
//
// What bounds it: at decode (M <= 8) the weight bytes, (K/2)*N + 4*(K/g)*N per call,
// about 4 GB per Llama-3-8B step. The design for that: each thread reads 4 packed
// bytes of one row (one 32-bit load; a warp reads 128 contiguous bytes), loops down
// the K/2 rows of its K-split, and keeps every M row of its tile in registers, so a
// weight byte is read from device memory once per M tile. A K-split across blocks
// (chosen from K and N only) gives the card enough blocks at N = 4096; a second
// small kernel sums the splits in a fixed order. Products bf16(x) * code are exact in
// f32, and each output element is summed in an order that does not depend on M, so
// a row's result does not depend on what shares its batch (the serving loop's
// isolation contract). Arithmetic is f32 FMA on the CUDA cores; at M = 8 that, not
// the bytes, is the limit of this first version (tensor cores are later work).
//
// K8 and K9 replace micronet_tpu/ops/int4_matmul.py::int4_matmul and ::int4_matmul_grouped
// (Pallas bodies _kernel and _kernel_grouped) over the plain packing (pack_int4): packed
// row r holds weight row r in its low nibble, sign-extended as (b << 4) >> 4, and row
// K/2 + r in its high nibble, b >> 4 (arithmetic). Both run the low and the high half as
// two f32 sums (the Pallas split-K double dot) and add them at the end.
//   K8: out[m, n] = (sum_lo bf16(x) * q + sum_hi bf16(x) * q) * scale[n]: per-column
//       scales, applied once in the epilogue (after the K-split sum).
//   K9: out[m, n] = sum_lo bf16(x) * w + sum_hi bf16(x) * w, w = bf16(f32(q) * gscale),
//       each weight dequantized once, rounded to bf16, before the dot: its scale varies
//       along K (row r of the low half uses scale row r / g, of the high half K/(2g) + r / g;
//       g must divide K/2). Every product is exact in f32 (8-bit x 8-bit mantissas).
//
// What bounds K8/K9: at decode (M <= 8) the weight bytes, (K/2)*N (+ the scales) per call.
// Their design (the w4 kernel below):
// - The product runs on the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32, with A and B
//   swapped: 16 weight columns form the 16-row operand, x^T (8 batch rows, zero-padded) the
//   n = 8 operand. A block holds 8 or 16 batch rows (MB = 1 or 2 n-tiles); larger M takes
//   more blocks along grid.x, which share their weight tile through L2.
// - Bytes in flight: a block of 8 warps owns 128 columns and streams its packed rows, with
//   the x values of the same rows (f32, both halves), through a ring of shared-memory slots of
//   64 rows: 16-byte cp.async.cg (4-byte cp.async.ca where N % 16 != 0 or K % 8 != 0), six
//   slots (48 KB of weights) ahead at MB = 1, two blocks an SM. Warp (kw, cw) takes the 16-row
//   k-tile kw of every slot and the 64 columns cw: a K-split inside the block, reduced through
//   shared memory in kw order.
// - A K-split across blocks (splits from K, N and the card only, never from M: ops/
//   int4_matmul.py::_w4_splits) fills 132 SMs at N = 4096. Each split writes its partial
//   tile to a workspace; the block that arrives last (an int counter per output tile, reset
//   by that block) sums the splits in split order, applies K8's column scale and writes the
//   output. No float atomics, no second launch. (Summing the splits in a thread-block
//   cluster through distributed shared memory instead measured slower on an H100.)
// - Fragment mapping (no conversion instructions): within a 16-row k-tile, MMA k index 2t,
//   2t+1, 2t+8, 2t+9 (t = lane % 4) is packed row t, t+4, t+8, t+12; within a warp's 64
//   columns, MMA row g (g = lane / 4) of n-tile j is column 8g + 2j and row g + 8 is column
//   8g + 2j + 1. So each thread reads 8 contiguous bytes of 4 packed rows from shared memory
//   and holds, per n-tile, the two bytes of each row its fragment needs; its x fragment is read
//   at the same packed rows and rounded to bf16 there (cvt.rn.bf16x2.f32). Every output element
//   is still one column's dot over all of K, summed in an order fixed by K, N and the card.
// - Dequantize. K8: a byte permute puts the bytes of two packed rows side by side, then
//   ((v >> s) & 0x000F000F) ^ 0x43084308 is two bf16 128 + (q + 8), and one bf16x2 fma
//   subtracts 136: q exactly. K9: (nibble ^ 8) permuted into the mantissa of f32 2^23, minus
//   2^23 + 8, is q exactly; then one f32 multiply by the group scale and one rounding to bf16
//   per value (cvt.rn.bf16x2.f32 on pairs): the twin's bf16(f32(q) * gscale), so every
//   product is exact in f32.
// - The low and the high half run as two f32 accumulators, added where a warp's K slice
//   ends; a row's result does not depend on what shares its batch (an MMA output element
//   depends only on its own operand row and column, and the k order is fixed).
// - Diagnostic builds (tools/w4_variants.py, through ops/_build.py's defines): W4_NO_COMPUTE
//   keeps the copies and the split sum but no warp computes; W4_NO_REDUCE skips the split sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                     // columns per thread: one 32-bit load
constexpr int kBlockN = kThreads * kCols;    // 512 columns per block
constexpr int kMaxGroup = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// grid: x = M tile (fastest, so blocks sharing a weight tile run together and hit
// L2), y = column block, z = K split.
template <int MT>
__global__ void __launch_bounds__(kThreads)
int4_hl8_kernel(const float* __restrict__ x, const int8_t* __restrict__ packed,
                const float* __restrict__ gscale, float* __restrict__ dst,
                int M, int K, int N, int group, int splits) {
  const int k2 = K / 2;
  const int g1 = k2 / group;
  const int m0 = blockIdx.x * MT;
  const int n0 = (blockIdx.y * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.z;
  const int gi_begin = (int)((long long)g1 * split / splits);
  const int gi_end = (int)((long long)g1 * (split + 1) / splits);
  const bool col_ok = n0 < N;  // the wrapper checks N % 4 == 0

  __shared__ float xs_lo[MT][kMaxGroup];
  __shared__ float xs_hi[MT][kMaxGroup];

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int gi = gi_begin; gi < gi_end; ++gi) {
    const int r0 = gi * group;
    __syncthreads();  // previous group's x tile fully read
    for (int i = threadIdx.x; i < MT * group; i += kThreads) {
      const int m = i / group, j = i - (i / group) * group;
      float lo = 0.f, hi = 0.f;
      if (m0 + m < M) {
        const float* xr = x + (size_t)(m0 + m) * K;
        lo = bf16_round(xr[r0 + j]);
        hi = bf16_round(xr[k2 + r0 + j]);
      }
      xs_lo[m][j] = lo;
      xs_hi[m][j] = hi;
    }
    __syncthreads();
    if (!col_ok) continue;  // still joins every __syncthreads above

    float plo[MT][kCols], phi[MT][kCols];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) plo[m][c] = phi[m][c] = 0.f;

    const int8_t* wp = packed + (size_t)r0 * N + n0;
#pragma unroll 4
    for (int j = 0; j < group; ++j) {
      const int w = __ldg(reinterpret_cast<const int*>(wp + (size_t)j * N));
      float ql[kCols], qh[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int b = (int)(int8_t)((w >> (8 * c)) & 0xFF);  // signed hl8 byte
        qh[c] = (float)(b >> 4);
        ql[c] = (float)((b & 0xF) - 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs_lo[m][j], xh = xs_hi[m][j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // exact products (8-bit x 4-bit mantissas): FMA == mul + add here
          plo[m][c] = fmaf(xl, ql[c], plo[m][c]);
          phi[m][c] = fmaf(xh, qh[c], phi[m][c]);
        }
      }
    }
    const float4 slo = __ldg(reinterpret_cast<const float4*>(gscale + (size_t)gi * N + n0));
    const float4 shi = __ldg(reinterpret_cast<const float4*>(gscale + (size_t)(g1 + gi) * N + n0));
    const float sl[kCols] = {slo.x, slo.y, slo.z, slo.w};
    const float sh[kCols] = {shi.x, shi.y, shi.z, shi.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        // rounded mul, then add: the oracle's acc + p_lo * s_lo + p_hi * s_hi order
        acc[m][c] = __fadd_rn(acc[m][c], __fmul_rn(plo[m][c], sl[c]));
        acc[m][c] = __fadd_rn(acc[m][c], __fmul_rn(phi[m][c], sh[c]));
      }
  }
  if (!col_ok) return;
  float* base = dst + (size_t)split * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {
      *reinterpret_cast<float4*>(base + (size_t)(m0 + m) * N + n0) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

// out[i] = ws[0][i] + ws[1][i] + ... in split order (deterministic)
__global__ void splitk_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                  int splits, long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, ws[k * mn + i]);
    out[i] = s;
  }
}

int splitk_sum(const float* ws, float* out, int splits, int M, int N, cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_sum_kernel<<<blocks, 256, 0, stream>>>(ws, out, splits, mn);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K8 and K9: the w4 kernel

constexpr int kW4Threads = 256;               // 8 warps: 4 k-slices x 2 column halves
constexpr int kW4BlockN = 128;                // columns per block
constexpr int kW4ColWarps = kW4BlockN / 64;   // a warp's columns: 4 MMA tiles of 16
constexpr int kW4KWarps = 8 / kW4ColWarps;    // a k-slice takes one 16-row k-tile of a slot
constexpr int kW4StageRows = 16 * kW4KWarps;  // packed rows per slot
constexpr int kW4Pitch = kW4BlockN + 32;      // bytes per staged weight row (conflict-free reads)
constexpr int kW4WBytes = kW4StageRows * kW4Pitch;
constexpr int kW4XPitch = kW4StageRows + 4;   // floats per staged x row (conflict-free reads)
// a ring slot: the weight tile, then x of both halves for 8 * MB batch rows
__host__ __device__ constexpr int w4_slot_bytes(int MB) {
  return kW4WBytes + 2 * 8 * MB * kW4XPitch * 4;
}
// ring depth: two blocks an SM at MB = 1 (102 KB each), one at MB = 2 (185 KB)
__host__ __device__ constexpr int w4_stages(int MB) { return MB == 1 ? 7 : 10; }
// the k-slices' partial tiles reuse the ring
static_assert(8 * 64 * 8 * 4 <= w4_stages(1) * w4_slot_bytes(1), "ring too small");
static_assert(8 * 64 * 16 * 4 <= w4_stages(2) * w4_slot_bytes(2), "ring too small");

// scales: K8's per column; K9's per group, a group a multiple of 16 rows (one k-tile in one
// group) or any group (each row's scale read where it is used)
enum W4Mode { kW4Col = 0, kW4Group = 1, kW4GroupAny = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies of 16 or 4 bytes; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K8: the signed nibbles at bits 0..3 and 16..19 of v as two exact bf16 codes:
// 0x4300 | (u ^ 8) is bf16 128 + (q + 8); minus 136 (0xC308) is q
__device__ __forceinline__ uint32_t dq_bf16x2(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) ^ 0x43084308u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// K9: byte kByte of v holds u ^ 8 (u a nibble); 0x4B0000vv is f32 2^23 + (q + 8), so
// subtracting 2^23 + 8 gives q exactly
template <int kByte>
__device__ __forceinline__ float q_f32(uint32_t v) {
  return __fadd_rn(__int_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | kByte)), -8388616.0f);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  union { __nv_bfloat162 h; uint32_t u; } p;
  p.h = __floats2bfloat162_rn(lo, hi);  // .x (the low half) = lo
  return p.u;
}

// 8 consecutive scales from p (zeros past column N)
__device__ __forceinline__ void load8(float (&s)[8], const float* p, int col, int N) {
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col + 4 * w < N) v = __ldg(reinterpret_cast<const float4*>(p + 4 * w));
    s[4 * w] = v.x; s[4 * w + 1] = v.y; s[4 * w + 2] = v.z; s[4 * w + 3] = v.w;
  }
}

// grid: x = batch tile of 8 * MB rows (fastest: blocks sharing a weight tile run together),
// y = column tile, z = K split (units of kW4StageRows packed rows). Dynamic shared memory: a
// ring of w4_stages(MB) slots, each the stage's weight bytes then its x values (f32).
template <int MB, int kMode, bool kVec16>
__global__ void __launch_bounds__(kW4Threads, MB == 1 ? 2 : 1)
w4_kernel(const float* __restrict__ x, const int8_t* __restrict__ packed,
          const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ ws,
          int* __restrict__ counters, int M, int K, int N, int group, int splits) {
  constexpr int kRows = 8 * MB;
  constexpr int kStages = w4_stages(MB);
  constexpr int kSlot = w4_slot_bytes(MB);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_block;
  const int k2 = K / 2;
  const int units = (k2 + kW4StageRows - 1) / kW4StageRows;
  const int u0 = (int)((long long)units * blockIdx.z / splits);
  const int nst = (int)((long long)units * (blockIdx.z + 1) / splits) - u0;
  const int row0 = u0 * kW4StageRows;
  const int m0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kW4BlockN;
  const int tid = threadIdx.x;
  const bool x_vec = ((K | k2) & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // stage st into its slot: the weight tile (rows past K/2 and columns past N as zeros), then
  // x of the stage's rows, both halves, as f32 [half][batch row][row] (zeros past M and K/2)
  auto load_stage = [&](int st) {
    uint8_t* dst = smem + (st % kStages) * kSlot;
    const int rb = row0 + st * kW4StageRows;
    constexpr int kBytes = kVec16 ? 16 : 4;
    constexpr int kPerRow = kW4BlockN / kBytes;
#pragma unroll
    for (int i = 0; i < kW4StageRows * kPerRow / kW4Threads; ++i) {
      const int idx = tid + i * kW4Threads;
      const int r = idx / kPerRow, c = (idx % kPerRow) * kBytes;
      const bool ok = rb + r < k2 && col0 + c < N;
      const int8_t* src = ok ? packed + (size_t)(rb + r) * N + col0 + c : packed;
      if (kVec16) cp_async16(dst + r * kW4Pitch + c, src, ok ? 16 : 0);
      else cp_async4(dst + r * kW4Pitch + c, src, ok ? 4 : 0);
    }
    float* xd = reinterpret_cast<float*>(dst + kW4WBytes);
    if (x_vec) {
      constexpr int kQuads = kW4StageRows / 4;
#pragma unroll
      for (int idx = tid; idx < 2 * kRows * kQuads; idx += kW4Threads) {
        const int hm = idx / kQuads, c = (idx % kQuads) * 4;
        const int m = m0 + hm % kRows;
        const bool ok = m < M && rb + c < k2;
        const float* src = ok ? x + (size_t)m * K + (hm / kRows) * k2 + rb + c : x;
        cp_async16(xd + hm * kW4XPitch + c, src, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < 2 * kRows * kW4StageRows; idx += kW4Threads) {
        const int hm = idx / kW4StageRows, c = idx % kW4StageRows;
        const int m = m0 + hm % kRows;
        const bool ok = m < M && rb + c < k2;
        const float* src = ok ? x + (size_t)m * K + (hm / kRows) * k2 + rb + c : x;
        cp_async4(xd + hm * kW4XPitch + c, src, ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % kW4KWarps, cw = warp / kW4KWarps;
  const int my_col = col0 + cw * 64 + 8 * g;  // the first of this thread's 8 columns
  const int g1 = kMode == kW4Col ? 0 : k2 / group;
  float acc[MB][4][2][4] = {};  // [batch n-tile][column n-tile][low, high half][fragment]
  float sl[8], sh[8];           // K9: this thread's columns' scales of the current group
  int next_group_row = 0;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed for all; the slot refilled below was read by all
    if (st + kStages - 1 < nst) load_stage(st + kStages - 1);
    cp_async_commit();
    const int kb = row0 + st * kW4StageRows + kw * 16;  // this warp's k-tile
#ifdef W4_NO_COMPUTE
    continue;  // diagnostic build: the copies alone
#endif
    if (kb >= k2) continue;  // warp-uniform: a tile of zeros
    const uint8_t* slot = smem + (st % kStages) * kSlot;
    const uint8_t* wsm = slot + (kw * 16 + t) * kW4Pitch + cw * 64 + 8 * g;
    uint2 wr[4];  // packed rows t + 4i, this thread's 8 columns
#pragma unroll
    for (int i = 0; i < 4; ++i) wr[i] = *reinterpret_cast<const uint2*>(wsm + 4 * i * kW4Pitch);
    // x fragments: batch row 8b + g; b0 = rows (t, t + 4), b1 = rows (t + 8, t + 12)
    const float* xsm = reinterpret_cast<const float*>(slot + kW4WBytes) + kw * 16 + t;
    uint32_t bl[MB][2], bh[MB][2];
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      const float* xl = xsm + (8 * b + g) * kW4XPitch;
      const float* xh = xl + kRows * kW4XPitch;
      bl[b][0] = pack_bf16x2(xl[0], xl[4]);
      bl[b][1] = pack_bf16x2(xl[8], xl[12]);
      bh[b][0] = pack_bf16x2(xh[0], xh[4]);
      bh[b][1] = pack_bf16x2(xh[8], xh[12]);
    }
    if (kMode == kW4Col) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // bytes of columns 2j, 2j+1 of rows (0, 1) and (2, 3), side by side
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t t01 =
            __byte_perm(j < 2 ? wr[0].x : wr[0].y, j < 2 ? wr[1].x : wr[1].y, sel);
        const uint32_t t23 =
            __byte_perm(j < 2 ? wr[2].x : wr[2].y, j < 2 ? wr[3].x : wr[3].y, sel);
        const uint32_t alo[4] = {dq_bf16x2(t01), dq_bf16x2(t01 >> 8), dq_bf16x2(t23),
                                 dq_bf16x2(t23 >> 8)};
        const uint32_t ahi[4] = {dq_bf16x2(t01 >> 4), dq_bf16x2(t01 >> 12), dq_bf16x2(t23 >> 4),
                                 dq_bf16x2(t23 >> 12)};
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          mma_bf16(acc[b][j][0], alo, bl[b][0], bl[b][1]);
          mma_bf16(acc[b][j][1], ahi, bh[b][0], bh[b][1]);
        }
      }
    } else {
      const float* srow[4] = {nullptr, nullptr, nullptr, nullptr};  // kW4GroupAny: row i's
      if (kMode == kW4Group) {
        if (kb >= next_group_row) {  // a group starts (or this split does)
          const int gi = kb / group;
          next_group_row = (gi + 1) * group;
          load8(sl, scale + (size_t)gi * N + my_col, my_col, N);
          load8(sh, scale + (size_t)(g1 + gi) * N + my_col, my_col, N);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kb + t + 4 * i < k2) srow[i] = scale + (size_t)((kb + t + 4 * i) / group) * N;
      }
      // the low half, then the high half: fewer values live at once
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[4][2];  // nibble ^ 8 in each byte, rows t + 4i, columns 0-3 and 4-7
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i][0] = ((h ? wr[i].x >> 4 : wr[i].x) & 0x0F0F0F0Fu) ^ 0x08080808u;
          v[i][1] = ((h ? wr[i].y >> 4 : wr[i].y) & 0x0F0F0F0Fu) ^ 0x08080808u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float w[4][2];  // [row i][column 2j + e], rounded to bf16 once, in pack_bf16x2
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * j + e;
              float s;
              if (kMode == kW4Group) {
                s = h ? sh[c] : sl[c];
              } else {
                const bool ok = srow[i] != nullptr && my_col + c < N;
                s = ok ? __ldg(srow[i] + (size_t)h * g1 * N + my_col + c) : 0.f;
              }
              const uint32_t word = v[i][j >> 1];
              const int byte = 2 * (j & 1) + e;  // constant once unrolled
              const float q = byte == 0 ? q_f32<0>(word)
                              : byte == 1 ? q_f32<1>(word)
                              : byte == 2 ? q_f32<2>(word) : q_f32<3>(word);
              w[i][e] = __fmul_rn(q, s);
            }
          }
          const uint32_t a[4] = {pack_bf16x2(w[0][0], w[1][0]), pack_bf16x2(w[0][1], w[1][1]),
                                 pack_bf16x2(w[2][0], w[3][0]), pack_bf16x2(w[2][1], w[3][1])};
#pragma unroll
          for (int b = 0; b < MB; ++b)
            mma_bf16(acc[b][j][h], a, h ? bh[b][0] : bl[b][0], h ? bh[b][1] : bl[b][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the k-slices' partial tiles now

  // each warp's low + high sums; fragment c[e2] is column 8g + 2j, batch row 2t + e2, and
  // c[2 + e2] column 8g + 2j + 1
  float* red = reinterpret_cast<float*>(smem);  // [kw][cw][kRows][64]
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __fadd_rn(acc[b][j][0][e2], acc[b][j][1][e2]);
        v[2 * j + 1] = __fadd_rn(acc[b][j][0][2 + e2], acc[b][j][1][2 + e2]);
      }
      float* dst = red + ((kw * kW4ColWarps + cw) * kRows + 8 * b + 2 * t + e2) * 64 + 8 * g;
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  __syncthreads();

  // the block's tile: the k-slices summed in kw order. With one split it is the output
  // (times K8's scale); with several, each split writes its tile to the workspace and the
  // last to arrive (an int counter per output tile, reset by that block) sums them in split
  // order
  constexpr int kQuads = kRows * kW4BlockN / 4;
  auto store = [&](int m, int n, float4 s) {
    if (kMode == kW4Col) {
      const float4 cs = __ldg(reinterpret_cast<const float4*>(scale + n));
      s = make_float4(__fmul_rn(s.x, cs.x), __fmul_rn(s.y, cs.y), __fmul_rn(s.z, cs.z),
                      __fmul_rn(s.w, cs.w));
    }
    *reinterpret_cast<float4*>(out + (size_t)m * N + n) = s;
  };
  for (int q = tid; q < kQuads; q += kW4Threads) {
    const int row = q / (kW4BlockN / 4), c4 = (q % (kW4BlockN / 4)) * 4;
    const int m = m0 + row, n = col0 + c4;
    if (m >= M || n >= N) continue;
    const float* src = red + (c4 / 64 * kRows + row) * 64 + c4 % 64;
    float4 s = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 1; k < kW4KWarps; ++k)
      s = add4(s, *reinterpret_cast<const float4*>(src + k * kW4ColWarps * kRows * 64));
    if (splits == 1) store(m, n, s);
    else __stcg(reinterpret_cast<float4*>(ws + ((size_t)blockIdx.z * M + m) * N + n), s);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
#ifdef W4_NO_REDUCE
  if (tid == 0) last_block = 0;  // diagnostic build: no split sum (split calls are wrong)
#else
  if (tid == 0) last_block = atomicAdd(counters + tile, 1) == splits - 1;
#endif
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int q = tid; q < kQuads; q += kW4Threads) {
    const int row = q / (kW4BlockN / 4), c4 = (q % (kW4BlockN / 4)) * 4;
    const int m = m0 + row, n = col0 + c4;
    if (m >= M || n >= N) continue;
    float4 s = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)m * N + n));
    for (int k = 1; k < splits; ++k)
      s = add4(s, __ldcg(reinterpret_cast<const float4*>(ws + ((size_t)k * M + m) * N + n)));
    store(m, n, s);
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next call on this stream
}

template <int MB, int kMode, bool kVec16>
int w4_launch(const void* x, const void* packed, const void* scale, void* out, void* ws,
              void* counters, int M, int K, int N, int group, int splits, cudaStream_t st) {
  constexpr int kSmem = w4_stages(MB) * w4_slot_bytes(MB);
  auto kern = w4_kernel<MB, kMode, kVec16>;
  static bool allowed[64] = {};  // the shared-memory limit raised, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !allowed[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) allowed[dev] = true;
  }
  const dim3 grid((M + 8 * MB - 1) / (8 * MB), (N + kW4BlockN - 1) / kW4BlockN, splits);
  kern<<<grid, kW4Threads, kSmem, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), M, K, N, group, splits);
  return (int)cudaGetLastError();
}

template <int kMode>
int w4_dispatch(const void* x, const void* packed, const void* scale, void* out, void* ws,
                void* counters, int M, int K, int N, int group, int splits, int mb,
                void* stream) {
  const int k2 = K / 2;
  const int units = (k2 + kW4StageRows - 1) / kW4StageRows;
  if (M <= 0 || K <= 0 || K % 2 || N <= 0 || N % 4 || (N + kW4BlockN - 1) / kW4BlockN > 65535 ||
      splits < 1 || splits > units || (mb != 1 && mb != 2) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (kMode != kW4Col && (group <= 0 || k2 % group)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  if (mb == 1)
    return vec16 ? w4_launch<1, kMode, true>(x, packed, scale, out, ws, counters, M, K, N, group,
                                             splits, st)
                 : w4_launch<1, kMode, false>(x, packed, scale, out, ws, counters, M, K, N,
                                              group, splits, st);
  return vec16 ? w4_launch<2, kMode, true>(x, packed, scale, out, ws, counters, M, K, N, group,
                                           splits, st)
               : w4_launch<2, kMode, false>(x, packed, scale, out, ws, counters, M, K, N, group,
                                            splits, st);
}

template <int MT>
void launch(const float* x, const int8_t* packed, const float* gscale, float* dst,
            int M, int K, int N, int group, int splits, cudaStream_t stream) {
  dim3 grid((M + MT - 1) / MT, (N + kBlockN - 1) / kBlockN, splits);
  int4_hl8_kernel<MT><<<grid, kThreads, 0, stream>>>(x, packed, gscale, dst, M, K, N,
                                                      group, splits);
}

}  // namespace

// x (M, K) f32, packed (K/2, N) int8 hl8, gscale (K/group, N) f32, out (M, N) f32.
// With splits > 1, ws is a (splits, M, N) f32 scratch; with splits == 1 it is unused.
extern "C" int mn_int4_matmul_grouped_hl8(const void* x, const void* packed,
                                          const void* gscale, void* out, void* ws,
                                          int M, int K, int N, int group, int splits,
                                          void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % kCols || group <= 0 || group > kMaxGroup ||
      (K / 2) % group || splits < 1 || splits > (K / 2) / group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  const float* xf = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(packed);
  const float* gs = static_cast<const float*>(gscale);
  if (M == 1) launch<1>(xf, wp, gs, dst, M, K, N, group, splits, st);
  else if (M == 2) launch<2>(xf, wp, gs, dst, M, K, N, group, splits, st);
  else if (M <= 4) launch<4>(xf, wp, gs, dst, M, K, N, group, splits, st);
  else launch<8>(xf, wp, gs, dst, M, K, N, group, splits, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_sum(static_cast<const float*>(ws), static_cast<float*>(out), splits, M, N, st);
}

// K8: x (M, K) f32, packed (K/2, N) int8 (pack_int4), scale (N,) f32, out (M, N) f32.
// splits (the K-split, from ops/int4_matmul.py::_w4_splits) and mb (1 for M <= 8, else 2:
// batch rows of a block / 8) come from the wrapper. With splits > 1, ws is a (splits, M, N)
// f32 scratch and counters holds one zeroed int per output tile (batch tiles x column
// tiles), left zeroed again; with splits == 1 both are unused.
extern "C" int mn_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                              void* ws, void* counters, int M, int K, int N, int splits, int mb,
                              void* stream) {
  return w4_dispatch<kW4Col>(x, packed, scale, out, ws, counters, M, K, N, 0, splits, mb,
                             stream);
}

// K9: as K8 with gscale (K/group, N) f32; group must divide K/2.
extern "C" int mn_int4_matmul_grouped(const void* x, const void* packed, const void* gscale,
                                      void* out, void* ws, void* counters, int M, int K, int N,
                                      int group, int splits, int mb, void* stream) {
  if (group > 0 && group % 16 == 0)
    return w4_dispatch<kW4Group>(x, packed, gscale, out, ws, counters, M, K, N, group, splits,
                                 mb, stream);
  return w4_dispatch<kW4GroupAny>(x, packed, gscale, out, ws, counters, M, K, N, group, splits,
                                  mb, stream);
}
