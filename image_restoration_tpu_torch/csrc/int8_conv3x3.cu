// int8 3x3 convolution with a fused requantization epilogue, for Hopper
// (sm_90a): an implicit GEMM on the int8 tensor cores (wgmma).
//
// Replaces the TPU kernel image_restoration_tpu/ops/pallas/int8_conv.py
// `int8_conv3x3_requant` (body `_kernel`): nine shifted int8 x int8 -> int32
// products summed over the input channels, then one of three epilogues:
//   mode 0 (f32), the Pallas formula: h = acc * deq[o] + b[o] in f32 with no
//     FMA contraction (__fmul_rn/__fadd_rn), PReLU, h * (127 / s_out) with
//     the ratio divided once in f32, round half to even, clip to +-127, int8;
//   mode 1 (bf16), the SRVGG chain's formula (ops/quantized_inference.py):
//     deq/b/alpha are bf16 (127 / s_out folded in, s_out unused) and every
//     operation rounds to bf16 as PyTorch and XLA do: acc -> f32 -> bf16,
//     x deq, + b, x alpha; then round half to even and clip, int8;
//   mode 2 (bf16_deq): acc -> f32 -> bf16, x deq, + b when bias is not NULL,
//     each rounded to bf16; no activation, round or clip; bf16 out;
//   mode 3 (rrdb_dense), one stage s of the int8 RRDB chain's widened dense
//     block (ops/rrdb_quant.py), mode 2's h = bf16(bf16(acc) x deq (+ b))
//     carried on through the block's glue. P is the block's running bf16
//     buffer of slice sums (N, H, W, 160), channels [c2 | c3 | c4 | x5]:
//       s = 0 (64 -> 192): q = int8(clip(rint(lrelu(h[c1])))), P = h[c2..x5];
//       s = 1..3 (32 -> 160/128/96): v = bf16(P[c_s+1] + h[c_s+1]),
//         q = int8(clip(rint(lrelu(v)))); P[k] = bf16(P[k] + h[k]) for every
//         later slice k, in place;
//       s = 4 (32 -> 64): t' = bf16(bf16(P[x5] + h) + t); in a block's third
//         dense block the carry y = bf16(bf16(t' x 0.2) + body), else y = t';
//         y out in bf16 and, but for the network's last dense block, the
//         next one's input q = int8(clip(rint(bf16(y x rin)))).
//     lrelu(v) = v >= 0 ? v : bf16(v x bf16(0.2)); q is the next stage's
//     input. Every step rounds where the chain's PyTorch ops round, and bf16
//     addition commutes, so P + h equals the chain's left-to-right slice sum.
// alpha == NULL means no PReLU (alpha = 1). The int32 sums are exact in any
// order (|acc| <= 9 * 192 * 127^2 < 2^31), so the kernel is bit-equal to its
// plain version (ops/int8_conv.py).
//
// Paths and bounds (H100 SXM: 1,979 int8 Tops/s, 3.35 TB/s):
//   the int8 SRVGG chain, 34 launches per engine call of 8 tiles of 528^2
//     packed two to a channel axis (N = 4; Cin/Cout 6/128 (Cin padded to 32),
//     128/128 x 32, 128/96). A body layer is 1.6e11 multiply-adds against
//     1.4e8 bytes: bound by operations, 0.166 ms; 5.49 ms per engine call.
//   the int8 RRDB chain, 345 launches per RRDBNet-23 forward of a 528^2 tile
//     (Cin 64 -> Cout 192, Cin 32 -> Cout 160/128/96/64, mode 3), with no
//     other kernel between them. Bytes per pixel of the five stages, input
//     and P/t/body read, q, P and y written: 64 + 32 + 320; 32 + 320 + 32 +
//     256; 32 + 256 + 32 + 192; 32 + 192 + 32 + 128; 32 + 128 + 128 (+ 128
//     body) + 128 + 64 = 2,432 a dense block (2,560 with the carry), against
//     4.2e5 int8 operations: every stage is bound by bytes, 0.73 ns a pixel
//     and dense block at 3.35 TB/s, 120.7 ms for the 69 dense blocks of a
//     call of 8 tiles of 544^2. P stays in device memory: at 544^2 it is
//     95 MB an image, above the 50 MB L2, and a stage needs all of it
//     before the next begins.
//
// Layout: x (N, Hin, Win, Cin) int8 NHWC with Cin a multiple of 32 and at
// most 192 (the wrapper pads with zero channels); w (Cout, 3, 3, Cin) int8;
// out (N, Hout, Wout, Cout) with Hout = Hin + 2*pad - 2. pad = 0 is the
// Pallas kernel's VALID conv over a pre-padded input (its border need not be
// zero); pad = 1 is the chain's SAME conv with an implied zero border.
//
// Design. GEMM view: M = output pixels, N = Cout, K = 9 taps x Cin, with both
// operands K-major as wgmma's 8-bit types require (A: an NHWC pixel's
// channels; B: the (Cout, 3, 3, Cin) weights).
// - Weights resident, persistent grid. A block keeps a whole weight slice of
//   NT output channels (Cout rounded up to 64, at most 192, less where shared
//   memory does not hold it) and walks output tiles, one block per SM; a
//   block reloads weights only where its walk crosses into the next slice.
// - Tiles of 8 rows x 24 columns (528 = 22 x 24). Three warpgroups each own
//   an 8 x 8 part, one wgmma M of 64, and issue m64nNTk32 .s32.s8.s8 with A
//   and B from shared memory through descriptors, no swizzle.
// - The implicit GEMM's trap is A: a tap is the input slab shifted by
//   (dy, dx) pixels. A warpgroup's 10 x 10 slab (halo included, zero outside
//   the image, loaded with cp.async) is stored [16-byte channel chunk][row]
//   [column], so for every tap its 64 A rows are eight runs of 8 consecutive
//   pixels: core matrices of 8 x 16 bytes at a uniform stride of one slab row
//   (SBO = 10 x 16 bytes), the next 16 channels one plane further (LBO). The
//   descriptor's start address just moves by (dy * 10 + dx) x 16 bytes: no
//   im2col copy, no copy per shift, no register-A path.
// - The warpgroups take turns on the tensor cores in a ring (named
//   barriers): while one runs its 9 x Cin/32 wgmma, the other two run their
//   epilogues, stores and next slab loads, which take longer than a wgmma
//   run. The wgmma are unrolled: in a loop ptxas fences each one.
// - Epilogue: the accumulator fragments go through the fast forms of the
//   three formulas (see `epilogue`; the scalar requant_f32 / requant_bf16 /
//   dequant_bf16 for a thread with a sum of 2^22 or more) into a staging
//   tile in shared memory (rows padded by 16 bytes against bank conflicts),
//   written out as 16-byte rows of contiguous channels, masked at H, W, Cout.
// - Mode 3 also loads the tile's P channels (and t and body at stage 4) with
//   cp.async into planes shaped like the staging tile, issued before the
//   warpgroup waits for its turn, so they land behind its wgmma and its
//   register epilogue. The store then reads 16 channels of h and of each
//   plane, finishes them in bf16x2 and writes 16-byte rows of q, P and y.
//   One warpgroup owns all of a pixel's channels of its slice, so the
//   in-place update of P has no race.
// Shared memory at the served shapes: 215,808 bytes (SR body, 128 -> 128),
// 210,048 (RRDB stage 0, 64 -> 192), 221,952 (stage 1, NT 192 with its P
// plane); 80-168 registers, no spills.
//
// C interface (loaded with ctypes): int8_conv3x3_requant (modes 0-2) and
// int8_conv3x3_rrdb_stage (mode 3) return cudaGetLastError() after the
// launch, 0 on success, or cudaErrorInvalidValue for arguments they do not
// take. They launch on the given stream, do not synchronise and allocate
// nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWgs = 3;                 // warpgroups, one 8 x 8 part of a tile each
constexpr int kTH = 8;                  // output rows per tile
constexpr int kPartW = 8;               // columns of a warpgroup's part
constexpr int kTW = kWgs * kPartW;      // 24 output columns per tile
constexpr int kWgPix = kTH * kPartW;    // 64: wgmma's M
constexpr int kThreads = 128 * kWgs;
constexpr int kSlabRows = kTH + 2;
constexpr int kSlabCols = kPartW + 2;
constexpr int kSlabPix = kSlabRows * kSlabCols;  // 100
constexpr int kMaxCin = 192;
constexpr int kMaxNT = 192;
constexpr size_t kMaxSmem = 232448;             // H100: per block, opt-in

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int8_t clip_to_int8(float q) {
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// mode 0: the Pallas kernel's f32 epilogue.
__device__ __forceinline__ int8_t requant_f32(int acc, float deq, float b, float a,
                                              bool prelu, float ratio) {
  float h = __fadd_rn(__fmul_rn(__int2float_rn(acc), deq), b);
  if (prelu && !(h >= 0.f)) h = __fmul_rn(h, a);
  return clip_to_int8(rintf(__fmul_rn(h, ratio)));
}

// mode 2: the RRDB chain's dequantization, rounded to bf16 after each step.
__device__ __forceinline__ __nv_bfloat16 dequant_bf16(int acc, float deq, float b,
                                                      bool has_bias) {
  float h = round_bf16(__int2float_rn(acc));
  h = round_bf16(__fmul_rn(h, deq));
  if (has_bias) h = __fadd_rn(h, b);
  return __float2bfloat16_rn(h);
}

// mode 1: the chain's bf16 epilogue, rounded to bf16 after every operation.
__device__ __forceinline__ int8_t requant_bf16(int acc, float deq, float b, float a,
                                               bool prelu) {
  float h = round_bf16(__int2float_rn(acc));
  h = round_bf16(__fmul_rn(h, deq));
  h = round_bf16(__fadd_rn(h, b));
  if (prelu && !(h >= 0.f)) h = round_bf16(__fmul_rn(h, a));
  return clip_to_int8(rintf(h));
}

// acc as float without a conversion instruction: exact for
// -2^22 <= acc < 2^22 (then equal to __int2float_rn).
__device__ __forceinline__ float small_int_to_float(int acc) {
  return __int_as_float(acc + 0x4B400000) - 12582912.f;
}

// The low byte is rint(v) (round half to even) as int8, for |v| <= 127.
__device__ __forceinline__ uint32_t rint_bits(float v) {
  return __float_as_uint(v + 12582912.f);
}

// bf16x2 multiply and add, each rounded once to nearest even (an explicit
// rounding mode also keeps the compiler from fusing them into an fma).
__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  __nv_bfloat162 d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<uint32_t*>(&d))
      : "r"(*reinterpret_cast<uint32_t*>(&a)), "r"(*reinterpret_cast<uint32_t*>(&b)));
  return d;
}

__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  __nv_bfloat162 d;
  asm("add.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<uint32_t*>(&d))
      : "r"(*reinterpret_cast<uint32_t*>(&a)), "r"(*reinterpret_cast<uint32_t*>(&b)));
  return d;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; valid == false writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every copy this thread has committed has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// byte offset between core matrices along K (LBO) and along M or N (SBO),
// all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// m64nNk32 s32 += s8 x s8, A and B from shared memory; d holds N / 2 sums.
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<192> {
  static __device__ __forceinline__ void mma(int (&d)[96], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// Keeps the compiler from moving accumulator accesses across wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const void* deq;
  const void* bias;   // may be NULL in mode 2
  const void* alpha;  // NULL: no PReLU
  float s_out;
  void* out;
  int n, hin, win, cin, cout, hout, wout, pad;
  int tiles_x, tiles_img, tiles_co, num_tiles;
  bool vec_store;     // 16-byte stores of the staged tile
};

// Mode 3's own arguments, a second kernel parameter, so that modes 0-2 keep
// their Args (a larger Args alone makes ptxas spill in them).
struct DenseArgs {
  __nv_bfloat16* p;   // (N, H, W, p_ch) slice sums
  int p_ch, p_off;    // P's channels; P's channel of output channel 0
  int nq;             // output channels 0 .. nq-1 -> q through LeakyReLU
  bool p_read;        // P + h (stages 1-4), else h (stage 0)
  int8_t* q;          // (N, H, W, nq), or at stage 4 (N, H, W, Cout) / NULL
  const __nv_bfloat16* t;     // stage 4: the residual (N, H, W, Cout)
  const __nv_bfloat16* body;  // stage 4 with the block carry, else NULL
  const __nv_bfloat16* rin;   // stage 4: the next input's scale, or NULL
  __nv_bfloat16* y;           // stage 4: (N, H, W, Cout)
  int planes;         // p_read + (t != NULL) + (body != NULL)
};

__device__ __forceinline__ float load_param(const void* p, int i, int mode) {
  return mode == 0 ? __ldg(static_cast<const float*>(p) + i)
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two int8 results in the low 16 bits.
__device__ __forceinline__ uint32_t pack_int8(int8_t q0, int8_t q1) {
  return (uint32_t)(uint8_t)q0 | ((uint32_t)(uint8_t)q1 << 8);
}

// Every copy but the newest `n` committed groups of this thread has landed.
template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// clip(rint(v), +-127) of a bf16 pair as two int8 in the low 16 bits.
__device__ __forceinline__ uint32_t int8x2(__nv_bfloat162 v) {
  v = __hmax2(__hmin2(v, __float2bfloat162_rn(127.f)), __float2bfloat162_rn(-127.f));
  return __byte_perm(rint_bits(__low2float(v)), rint_bits(__high2float(v)), 0x0040);
}

// 16 int8 from 8 bf16 pairs, packed into a 16-byte row.
__device__ __forceinline__ uint4 int8x16(const __nv_bfloat162 (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = __byte_perm(int8x2(v[2 * j]), int8x2(v[2 * j + 1]), 0x5410);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Mode 3's store: the staged h of one warpgroup's part, 16 channels (two
// 16-byte rows) a step, finished with the planes (P; t; body) in bf16x2 and
// written as 16-byte rows of q, P or y. Masked at H, W and Cout (Cout and nq
// are multiples of 16).
template <int NT>
__device__ __forceinline__ void store_rrdb(const Args& a, const DenseArgs& d,
                                           const unsigned char* s_out,
                                           const unsigned char* s_pl, int n, int y0, int x0,
                                           int co0, int wtid) {
  constexpr int pitch = NT * 2 + 16;
  constexpr int plane = kWgPix * pitch;
  constexpr int upp = NT / 16;                 // 16-channel steps per staged pixel
  constexpr int per = kWgPix * upp / 128;
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  const __nv_bfloat162 fifth2 = __float2bfloat162_rn(0.2f);  // bf16(0.2)
  const __nv_bfloat162 rin2 =
      d.rin != nullptr ? __bfloat162bfloat162(d.rin[0]) : __float2bfloat162_rn(1.f);
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int i = wtid + 128 * k, p = i / upp, u = i % upp;
    const int y = y0 + p / kPartW, xo = x0 + p % kPartW, o = co0 + 16 * u;
    if (y >= a.hout || xo >= a.wout || o >= a.cout) continue;
    const int64_t pix = ((int64_t)n * a.hout + y) * a.wout + xo;
    const int off = p * pitch + u * 32;
    __nv_bfloat162 v[8];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(s_out + off);
    *reinterpret_cast<uint4*>(v + 4) = *reinterpret_cast<const uint4*>(s_out + off + 16);
    if (d.p_read) {
      const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(s_pl + off);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = add_rn(pv[j], v[j]);
    }
    if (d.t != nullptr) {  // stage 4: x5 + t, the carry, y and the next q
      const __nv_bfloat162* tv = reinterpret_cast<const __nv_bfloat162*>(s_pl + plane + off);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = add_rn(v[j], tv[j]);
      if (d.body != nullptr) {
        const __nv_bfloat162* bv =
            reinterpret_cast<const __nv_bfloat162*>(s_pl + 2 * plane + off);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = add_rn(mul_rn(v[j], fifth2), bv[j]);
      }
      uint4* dst = reinterpret_cast<uint4*>(d.y + pix * a.cout + o);
      dst[0] = *reinterpret_cast<const uint4*>(v);
      dst[1] = *reinterpret_cast<const uint4*>(v + 4);
      if (d.q != nullptr) {
        __nv_bfloat162 s[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] = mul_rn(v[j], rin2);
        *reinterpret_cast<uint4*>(d.q + pix * a.cout + o) = int8x16(s);
      }
    } else if (o < d.nq) {  // the next stage's input: LeakyReLU, int8
#pragma unroll
      for (int j = 0; j < 8; ++j)  // min(v, 0) * 0.2 + max(v, 0): one rounding
        v[j] = __hfma2(__hmin2(v[j], zero2), fifth2, __hmax2(v[j], zero2));
      *reinterpret_cast<uint4*>(d.q + pix * d.nq + o) = int8x16(v);
    } else {  // a later slice's partial sum, in place
      uint4* dst = reinterpret_cast<uint4*>(d.p + pix * d.p_ch + d.p_off + o);
      dst[0] = *reinterpret_cast<const uint4*>(v);
      dst[1] = *reinterpret_cast<const uint4*>(v + 4);
    }
  }
}

// A warpgroup's epilogue into its staging tile. Fragment j holds channels
// 8j + 2q and 8j + 2q + 1 of rows 2*wq (h = 0) and 2*wq + 1 (h = 1) of its
// part, column g. Results are computed into registers eight fragments at a
// time and stored after, so that no shared-memory store orders the
// parameter loads of the next fragment.
// kFast (every acc of the thread in [-2^22, 2^22)): the same roundings
// without conversion instructions, which the card runs at a sixteenth of
// its add rate: acc -> f32 by a magic-number add, the bf16 chain in bf16x2
// arithmetic (a product of two bf16 values is exact in f32, and a sum of two
// rounds to the same bf16 whether or not it passes through f32 first), the
// round half to even by adding 1.5 * 2^23 after the clip. Otherwise the
// scalar requant_f32 / requant_bf16 / dequant_bf16.
template <int NT, int kMode, bool kFast>
__device__ __forceinline__ void epilogue(const int (&acc)[NT / 2], unsigned char* s_out,
                                         const float* s_par, const __nv_bfloat162* s_par2,
                                         bool prelu, bool has_bias, float ratio, int wq,
                                         int g, int q) {
  constexpr int esize = kMode >= 2 ? 2 : 1;
  constexpr int pitch = NT * esize + 16;
  constexpr int kGroup = 8;  // fragments computed before their stores
  static_assert(NT / 8 % kGroup == 0, "NT is a multiple of 64");
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  const __nv_bfloat162 lo2 = __float2bfloat162_rn(-127.f);
  const __nv_bfloat162 hi2 = __float2bfloat162_rn(127.f);
#pragma unroll
  for (int j0 = 0; j0 < NT / 8; j0 += kGroup) {
    uint32_t res[2 * kGroup];
#pragma unroll
    for (int j = j0; j < j0 + kGroup; ++j) {
      const int ch = 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        uint32_t& r = res[2 * (j - j0) + h];
        if constexpr (kFast && kMode != 0) {
          __nv_bfloat162 hb =
              __floats2bfloat162_rn(small_int_to_float(v0), small_int_to_float(v1));
          hb = add_rn(mul_rn(hb, s_par2[ch / 2]), s_par2[NT / 2 + ch / 2]);
          if constexpr (kMode >= 2) {
            r = bits(hb);
          } else {
            // PReLU as min(h, 0) * a + max(h, 0): h >= 0 ? h : bf16(h * a)
            hb = __hfma2(__hmin2(hb, zero2), s_par2[NT + ch / 2], __hmax2(hb, zero2));
            hb = __hmax2(__hmin2(hb, hi2), lo2);
            r = __byte_perm(rint_bits(__low2float(hb)), rint_bits(__high2float(hb)),
                            0x0040);
          }
        } else if constexpr (kFast) {
          float h0 = __fadd_rn(__fmul_rn(small_int_to_float(v0), s_par[ch]), s_par[NT + ch]);
          float h1 = __fadd_rn(__fmul_rn(small_int_to_float(v1), s_par[ch + 1]),
                               s_par[NT + ch + 1]);
          h0 = h0 >= 0.f ? h0 : __fmul_rn(h0, s_par[2 * NT + ch]);
          h1 = h1 >= 0.f ? h1 : __fmul_rn(h1, s_par[2 * NT + ch + 1]);
          h0 = fminf(fmaxf(__fmul_rn(h0, ratio), -127.f), 127.f);
          h1 = fminf(fmaxf(__fmul_rn(h1, ratio), -127.f), 127.f);
          r = __byte_perm(rint_bits(h0), rint_bits(h1), 0x0040);
        } else if constexpr (kMode >= 2) {
          __nv_bfloat162 pr;
          pr.x = dequant_bf16(v0, s_par[ch], s_par[NT + ch], has_bias);
          pr.y = dequant_bf16(v1, s_par[ch + 1], s_par[NT + ch + 1], has_bias);
          r = bits(pr);
        } else if constexpr (kMode == 1) {
          r = pack_int8(
              requant_bf16(v0, s_par[ch], s_par[NT + ch], s_par[2 * NT + ch], prelu),
              requant_bf16(v1, s_par[ch + 1], s_par[NT + ch + 1], s_par[2 * NT + ch + 1],
                           prelu));
        } else {
          r = pack_int8(
              requant_f32(v0, s_par[ch], s_par[NT + ch], s_par[2 * NT + ch], prelu, ratio),
              requant_f32(v1, s_par[ch + 1], s_par[NT + ch + 1], s_par[2 * NT + ch + 1],
                          prelu, ratio));
        }
      }
    }
#pragma unroll
    for (int j = j0; j < j0 + kGroup; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* dst =
            s_out + ((2 * wq + h) * kPartW + g) * pitch + (8 * j + 2 * q) * esize;
        if constexpr (kMode >= 2)
          *reinterpret_cast<uint32_t*>(dst) = res[2 * (j - j0) + h];
        else
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(res[2 * (j - j0) + h]);
      }
    }
  }
}

// Barrier ids: 0 is __syncthreads; 1 + w warpgroup w's own; 1 + kWgs + w
// hands the tensor cores to warpgroup w.
constexpr int kBarWg = 1;
constexpr int kBarTurn = 1 + kWgs;

// The kernel's body; d is read in mode 3 only.
template <int NT, int kMode>
__device__ __forceinline__ void conv_body(const Args& a, const DenseArgs& d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int esize = kMode >= 2 ? 2 : 1;
  constexpr int pitch = NT * esize + 16;       // staged output row, bytes
  const int chunks = a.cin / 16;               // 16-byte channel chunks per pixel
  const int slab_bytes = chunks * kSlabPix * 16;
  const int tid = threadIdx.x;
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: tile columns 8*wg .. 8*wg + 7
  const int wq = warp & 3;   // rows 2*wq, 2*wq + 1 of its M = 64
  const int w_bytes = 9 * a.cin * NT;
  unsigned char* s_w = smem;                   // [9 * chunks][NT][16 bytes]
  // per warpgroup: its slab [chunks][10 rows][10 columns][16 bytes] and its
  // staging tile [64 pixels][pitch]
  unsigned char* s_slab = smem + w_bytes + wg * slab_bytes;
  unsigned char* s_out = smem + w_bytes + kWgs * slab_bytes + wg * kWgPix * pitch;
  float* s_par = reinterpret_cast<float*>(smem + w_bytes + kWgs * slab_bytes +
                                          kWgs * kWgPix * pitch);  // deq, b, alpha
  __nv_bfloat162* s_par2 = reinterpret_cast<__nv_bfloat162*>(s_par + 3 * NT);
  // mode 3, per warpgroup: its planes (P; t; body), each [64 pixels][pitch]
  unsigned char* s_pl = reinterpret_cast<unsigned char*>(s_par2 + 3 * NT / 2) +
                        wg * d.planes * kWgPix * pitch;

  // This warpgroup's input slab of tile t: rows y0-pad .. y0-pad+9,
  // columns x0-pad .. x0-pad+9, zero outside the image.
  auto load_slab = [&](int t) {
    const int r = t % a.tiles_co;
    const int n = r / a.tiles_img;
    const int ty = (r % a.tiles_img) / a.tiles_x, tx = r % a.tiles_x;
    const int iy0 = ty * kTH - a.pad, ix0 = tx * kTW + wg * kPartW - a.pad;
    const int8_t* xn = a.x + (int64_t)n * a.hin * a.win * a.cin;
    if (wtid >= kSlabPix) return;  // one pixel per thread, all its chunks
    const int iy = iy0 + wtid / kSlabCols, ix = ix0 + wtid % kSlabCols;
    const bool valid = iy >= 0 && iy < a.hin && ix >= 0 && ix < a.win;
    const int8_t* src = valid ? xn + ((int64_t)iy * a.win + ix) * a.cin : a.x;
    const uint32_t dst = smem_u32(s_slab) + wtid * 16;
    for (int c = 0; c < chunks; ++c)
      cp_async16(dst + c * kSlabPix * 16, valid ? src + c * 16 : a.x, valid);
  };
  // Output channels co*NT .. co*NT + NT-1: weights (zero past Cout) and the
  // epilogue vectors, as float and as bf16 pairs.
  auto load_weights = [&](int co) {
    const int co0 = co * NT;
    const uint32_t dst = smem_u32(s_w);
    for (int i = tid; i < NT * 9 * chunks; i += kThreads) {
      const int o = i % NT, k = i / NT;
      const bool valid = co0 + o < a.cout;
      cp_async16(dst + i * 16,
                 valid ? a.w + (int64_t)(co0 + o) * 9 * a.cin + k * 16 : a.w, valid);
    }
    // vector k (0 deq, 1 bias, 2 alpha) at channel o. A missing bias is
    // -0 and a missing alpha 1, which leave every value as it is, so the
    // fast epilogue needs no branch on them.
    auto param = [&](int k, int o) {
      const void* p = k == 0 ? a.deq : k == 1 ? a.bias : a.alpha;
      if (p != nullptr && o < a.cout) return load_param(p, o, kMode);
      return k == 0 ? 0.f : k == 1 ? -0.f : 1.f;
    };
    for (int i = tid; i < 3 * NT; i += kThreads) s_par[i] = param(i / NT, co0 + i % NT);
    if constexpr (kMode != 0) {  // bf16 vectors: the pairs are exact
      for (int i = tid; i < 3 * NT / 2; i += kThreads) {
        const int k = i / (NT / 2), o = co0 + 2 * (i % (NT / 2));
        s_par2[i] = __floats2bfloat162_rn(param(k, o), param(k, o + 1));
      }
    }
  };

  // Mode 3: this warpgroup's planes of tile t, the tile's pixels and output
  // channels of P (at P's channel p_off + o), t and body. Out-of-range
  // pixels and channels are left as they are: the store skips them.
  auto load_planes = [&](int t) {
    const int r = t % a.tiles_co;
    const int n = r / a.tiles_img;
    const int y0 = (r % a.tiles_img) / a.tiles_x * kTH;
    const int x0 = r % a.tiles_x * kTW + wg * kPartW;
    const int co0 = t / a.tiles_co * NT;
    constexpr int cpp = NT / 8;  // 16-byte chunks per plane pixel
    constexpr int plane = kWgPix * pitch;
    const uint32_t base = smem_u32(s_pl);
    for (int i = wtid; i < kWgPix * cpp; i += 128) {
      const int p = i / cpp, c = i % cpp;
      const int y = y0 + p / kPartW, xo = x0 + p % kPartW, o = co0 + 8 * c;
      if (y >= a.hout || xo >= a.wout || o >= a.cout) continue;
      const int64_t pix = ((int64_t)n * a.hout + y) * a.wout + xo;
      const uint32_t dst = base + p * pitch + c * 16;
      if (d.p_read) cp_async16(dst, d.p + pix * d.p_ch + d.p_off + o, true);
      if (d.t != nullptr) cp_async16(dst + plane, d.t + pix * a.cout + o, true);
      if (d.body != nullptr) cp_async16(dst + 2 * plane, d.body + pix * a.cout + o, true);
    }
  };

  const bool prelu = a.alpha != nullptr, has_bias = a.bias != nullptr;
  const float ratio = __fdiv_rn(127.f, a.s_out);
  const int g = lane >> 2, q = lane & 3;  // accumulator row and column pair
  int cur_co = -1;
  int t = blockIdx.x;
  load_slab(t);
  cp_async_commit();
  // The warpgroups walk the same tiles, each its 8 x 8 part, and take turns
  // on the tensor cores in a ring: while one runs its wgmma, the others run
  // their epilogues, stores and the next slab's loads.
  for (int it = 0; t < a.num_tiles; ++it, t += gridDim.x) {
    const int co = t / a.tiles_co;
    const bool more = t + (int)gridDim.x < a.num_tiles;
    const bool new_co = co != cur_co;
    if (new_co) {
      __syncthreads();  // every warpgroup is done with the last weights
      load_weights(co);
      cur_co = co;
    }
    // This tile's slab (and the weights) have landed; the proxy fence makes
    // them visible to wgmma.
    cp_async_wait_all();
    fence_proxy_async();
    if (new_co) __syncthreads();
    else bar_sync(kBarWg + wg, 128);
    if constexpr (kMode == 3) {
      // every thread of the warpgroup is done with the last tile's planes
      if (d.planes > 0) load_planes(t);
      cp_async_commit();
    }
    if (wg != 0 || it > 0) bar_sync(kBarTurn + wg, 256);

    int acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
    const uint32_t a_base = smem_u32(s_slab);
    const uint32_t b_base = smem_u32(s_w);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // Unrolled, so that the wgmma run back to back on fixed accumulator
    // registers (in a loop ptxas fences each one).
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const uint32_t a_tap = a_base + (dy * kSlabCols + dx) * 16;
      const uint32_t b_tap = b_base + tap * chunks * NT * 16;
#pragma unroll
      for (int c = 0; c < kMaxCin / 16; c += 2) {
        if (c >= chunks) break;
        const uint64_t da = make_desc(a_tap + c * kSlabPix * 16, kSlabPix * 16, kSlabCols * 16);
        const uint64_t db = make_desc(b_tap + c * NT * 16, NT * 16, 128);
        Wgmma<NT>::mma(acc, da, db, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (wg < kWgs - 1) bar_arrive(kBarTurn + wg + 1, 256);
    else if (more) bar_arrive(kBarTurn, 256);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // every warp's wgmma are done with the slab: the next one loads behind
    // the epilogue
    bar_sync(kBarWg + wg, 128);
    if (more) load_slab(t + gridDim.x);
    cp_async_commit();

    uint32_t range = 0;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) range |= static_cast<uint32_t>(acc[i] + 0x400000);
    if ((range & 0xFF800000u) == 0)
      epilogue<NT, kMode, true>(acc, s_out, s_par, s_par2, prelu, has_bias, ratio, wq, g, q);
    else
      epilogue<NT, kMode, false>(acc, s_out, s_par, s_par2, prelu, has_bias, ratio, wq, g,
                                 q);
    if constexpr (kMode == 3) cp_async_wait_group<1>();  // the planes, not the next slab
    bar_sync(kBarWg + wg, 128);

    // The staged part to the output, masked at H, W and Cout.
    const int r = t % a.tiles_co;
    const int n = r / a.tiles_img;
    const int y0 = (r % a.tiles_img) / a.tiles_x * kTH;
    const int x0 = r % a.tiles_x * kTW + wg * kPartW;
    const int co0 = co * NT;
    unsigned char* outb = static_cast<unsigned char*>(a.out);
    if constexpr (kMode == 3) {
      store_rrdb<NT>(a, d, s_out, s_pl, n, y0, x0, co0, wtid);
    } else if (a.vec_store) {
      // 16-byte rows of contiguous channels; all loads first, then stores
      constexpr int cpp = NT * esize / 16;  // 16-byte chunks per staged pixel
      constexpr int per = kWgPix * cpp / 128;
      uint4 v[per];
#pragma unroll
      for (int k = 0; k < per; ++k) {
        const int i = wtid + 128 * k, p = i / cpp, c = i % cpp;
        v[k] = *reinterpret_cast<const uint4*>(s_out + p * pitch + c * 16);
      }
#pragma unroll
      for (int k = 0; k < per; ++k) {
        const int i = wtid + 128 * k, p = i / cpp, c = i % cpp;
        const int y = y0 + p / kPartW, xo = x0 + p % kPartW;
        if (y >= a.hout || xo >= a.wout || co0 + c * 16 / esize >= a.cout) continue;
        const int64_t at = (((int64_t)n * a.hout + y) * a.wout + xo) * a.cout + co0;
        *reinterpret_cast<uint4*>(outb + at * esize + c * 16) = v[k];
      }
    } else {
      for (int i = wtid; i < kWgPix * NT; i += 128) {
        const int p = i / NT, o = i - p * NT;
        const int y = y0 + p / kPartW, xo = x0 + p % kPartW;
        if (y >= a.hout || xo >= a.wout || co0 + o >= a.cout) continue;
        const int64_t at = (((int64_t)n * a.hout + y) * a.wout + xo) * a.cout + co0 + o;
        const unsigned char* src = s_out + p * pitch + o * esize;
        outb[at * esize] = src[0];
        if (esize == 2) outb[at * esize + 1] = src[1];
      }
    }
  }
}

template <int NT, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv3x3_wgmma(const Args a) {
  conv_body<NT, kMode>(a, DenseArgs{});
}

// mode 3
template <int NT, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv3x3_wgmma(const Args a, const DenseArgs d) {
  conv_body<NT, kMode>(a, d);
}

// planes: mode 3's bf16 planes a warpgroup (P; t; body), each one staging
// tile's size.
size_t smem_bytes(int nt, int cin, int mode, int planes = 0) {
  const int esize = mode >= 2 ? 2 : 1;
  return (size_t)9 * cin * nt + kWgs * (size_t)cin * kSlabPix +
         kWgs * (size_t)kWgPix * (nt * esize + 16) * (1 + planes) +
         3 * nt * sizeof(float) + 3 * nt / 2 * sizeof(__nv_bfloat162);
}

// d: mode 3's DenseArgs, none in modes 0-2.
template <int NT, int kMode, typename... D>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream, const D&... d) {
  void (*kernel)(const Args, const D...) = int8_conv3x3_wgmma<NT, kMode>;
  static size_t smem_allowed = 48 * 1024;  // dynamic shared memory without opt-in
  if (smem > smem_allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the persistent grid: at most as many blocks as fit on the card at once
  const int grid = (int)(a.num_tiles < (long long)sms * per_sm ? a.num_tiles : sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(a, d...);
  return cudaGetLastError();
}

template <int kMode, typename... D>
cudaError_t launch_mode(const Args& a, int nt, size_t smem, cudaStream_t stream,
                        const D&... d) {
  if (nt == 192) return launch<192, kMode>(a, smem, stream, d...);
  if (nt == 128) return launch<128, kMode>(a, smem, stream, d...);
  return launch<64, kMode>(a, smem, stream, d...);
}

// The geometry shared by every mode: the widest slice of output channels
// (64, 128 or 192) whose weights fit in shared memory beside the slabs, the
// staging tiles and mode 3's planes, and the persistent walk's tiles.
// Returns false for a shape the kernel does not take.
bool plan(Args& a, int n, int hin, int win, int cin, int cout, int pad, int mode,
          int planes, int* nt_out, size_t* smem_out) {
  const int hout = hin + 2 * pad - 2, wout = win + 2 * pad - 2;
  if (n <= 0 || cin <= 0 || cin % 32 != 0 || cin > kMaxCin || cout <= 0 ||
      (pad != 0 && pad != 1) || hout <= 0 || wout <= 0)
    return false;
  int nt = (cout + 63) / 64 * 64;
  if (nt > kMaxNT) nt = kMaxNT;
  while (nt > 64 && smem_bytes(nt, cin, mode, planes) > kMaxSmem) nt -= 64;
  const size_t smem = smem_bytes(nt, cin, mode, planes);
  const long long tiles_x = (wout + kTW - 1) / kTW, tiles_y = (hout + kTH - 1) / kTH;
  const long long tiles_co = (long long)n * tiles_y * tiles_x;
  const long long num_tiles = tiles_co * ((cout + nt - 1) / nt);
  if (smem > kMaxSmem || num_tiles > 0x7fffffff) return false;
  a.n = n;
  a.hin = hin;
  a.win = win;
  a.cin = cin;
  a.cout = cout;
  a.hout = hout;
  a.wout = wout;
  a.pad = pad;
  a.tiles_x = (int)tiles_x;
  a.tiles_img = (int)(tiles_y * tiles_x);
  a.tiles_co = (int)tiles_co;
  a.num_tiles = (int)num_tiles;
  *nt_out = nt;
  *smem_out = smem;
  return true;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// mode: 0 = f32 epilogue (deq/bias/alpha float32, s_out used), int8 out;
//       1 = bf16 epilogue (deq/bias/alpha bfloat16, s_out unused), int8 out;
//       2 = bf16_deq (deq/bias bfloat16, bias may be NULL, alpha must be
//           NULL, s_out unused), bf16 out.
// alpha may be NULL (no PReLU). pad is 0 or 1. cin is a multiple of 32 and
// at most 192; x and w are 16-byte aligned.
extern "C" int int8_conv3x3_requant(const void* x, const void* w, const void* deq,
                                    const void* bias, const void* alpha, float s_out,
                                    void* out, int n, int hin, int win, int cin,
                                    int cout, int pad, int mode, void* stream) {
  Args a = {};
  int nt = 0;
  size_t smem = 0;
  if (mode < 0 || mode > 2 || (mode != 2 && bias == nullptr) ||
      (mode == 2 && alpha != nullptr) || misaligned(x) || misaligned(w) ||
      !plan(a, n, hin, win, cin, cout, pad, mode, 0, &nt, &smem))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.deq = deq;
  a.bias = bias;
  a.alpha = alpha;
  a.s_out = s_out;
  a.out = out;
  const int esize = mode == 2 ? 2 : 1;
  a.vec_store = (cout * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = mode == 0   ? launch_mode<0>(a, nt, smem, s)
                        : mode == 1 ? launch_mode<1>(a, nt, smem, s)
                                    : launch_mode<2>(a, nt, smem, s);
  return (int)e;
}

// Mode 3, one stage of the int8 RRDB dense block, a SAME conv (pad 1): x
// (N, H, W, cin) int8, w (cout, 3, 3, cin) int8, deq and bias (may be NULL)
// bf16 vectors of cout, p (N, H, W, p_ch) bf16 updated in place.
//   stages 0-3: t, body, rin and y NULL; output channels below nq go to q
//     (N, H, W, nq) int8 through LeakyReLU (from P + h where p_read, else
//     h), the others to P's channel p_off + o (P + h where p_read, else h);
//   stage 4: p_read, nq 0, t (N, H, W, cout) bf16 and y (N, H, W, cout)
//     bf16 out; body (the carry) may be NULL; q (N, H, W, cout) int8 and rin
//     (a bf16 scalar on the device) both or neither.
// cout, nq and p_ch are multiples of 16, 16 and 8, p_off a multiple of 8,
// P's channels in range; every pointer but rin 16-byte aligned.
extern "C" int int8_conv3x3_rrdb_stage(const void* x, const void* w, const void* deq,
                                       const void* bias, void* p, int p_ch, int p_off,
                                       int p_read, int nq, void* q, const void* t,
                                       const void* body, const void* rin, void* y, int n,
                                       int h, int wd, int cin, int cout, void* stream) {
  const bool stage4 = t != nullptr;
  const int planes = (p_read ? 1 : 0) + (stage4 ? 1 : 0) + (body != nullptr ? 1 : 0);
  const int lo = p_read ? p_off : p_off + nq;  // the lowest P channel touched
  Args a = {};
  int nt = 0;
  size_t smem = 0;
  if (p == nullptr || cout % 16 != 0 || nq < 0 || nq % 16 != 0 || nq > cout ||
      p_ch % 8 != 0 || p_off % 8 != 0 || lo < 0 || p_off + cout > p_ch ||
      (stage4 ? (!p_read || nq != 0 || y == nullptr || (q == nullptr) != (rin == nullptr))
              : (q == nullptr || nq == 0 || body != nullptr || rin != nullptr ||
                 y != nullptr)) ||
      misaligned(x) || misaligned(w) || misaligned(p) || misaligned(q) || misaligned(t) ||
      misaligned(body) || misaligned(y) ||
      !plan(a, n, h, wd, cin, cout, 1, 3, planes, &nt, &smem))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.deq = deq;
  a.bias = bias;
  a.alpha = nullptr;
  a.s_out = 1.f;
  a.out = nullptr;
  a.vec_store = true;
  DenseArgs d;
  d.p = static_cast<__nv_bfloat16*>(p);
  d.p_ch = p_ch;
  d.p_off = p_off;
  d.nq = nq;
  d.p_read = p_read != 0;
  d.q = static_cast<int8_t*>(q);
  d.t = static_cast<const __nv_bfloat16*>(t);
  d.body = static_cast<const __nv_bfloat16*>(body);
  d.rin = static_cast<const __nv_bfloat16*>(rin);
  d.y = static_cast<__nv_bfloat16*>(y);
  d.planes = planes;
  return (int)launch_mode<3>(a, nt, smem, static_cast<cudaStream_t>(stream), d);
}

extern "C" const char* int8_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
