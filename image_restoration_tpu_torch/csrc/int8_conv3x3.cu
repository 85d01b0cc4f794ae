// int8 3x3 convolution with a fused requantization epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel image_restoration_tpu/ops/pallas/int8_conv.py
// `int8_conv3x3_requant` (body `_kernel`): nine shifted int8 x int8 -> int32
// products summed over the input channels, then
//     h = acc * deq[o] + b[o];  h = h >= 0 ? h : h * alpha[o];
//     out = clip(round_half_even(h * 127 / s_out), -127, 127)   as int8.
// It carries every layer of the int8 SRVGGNetCompact chain
// (ops/quantized_inference.py): 34 launches per engine call of 8 tiles of
// 528^2 packed two to a channel axis (N = 4, Cin/Cout 6/128, 128/128, 128/96).
//
// Layout: x (N, Hin, Win, Cin) int8 NHWC, Cin a multiple of 4 (the wrapper
// pads); w (Cout, 3, 3, Cin) int8; out (N, Hout, Wout, Cout) int8 with
// Hout = Hin + 2*pad - 2. pad = 0 is the Pallas kernel's VALID conv over a
// pre-padded input (its border need not be zero); pad = 1 is the SAME conv of
// the chain with an implied zero border, so no padded copy is made.
//
// Three epilogue modes, all fused:
//   mode 0 (f32), the Pallas formula: f32 multiply and add with no FMA
//     contraction (__fmul_rn/__fadd_rn), PReLU, h * (127 / s_out) with the
//     ratio divided once in f32, round half to even, clip.
//   mode 1 (bf16), the chain's formula (quantized_inference.py): deq/b/alpha
//     are bf16 and every operation rounds to bf16 as PyTorch and XLA do:
//     acc -> f32 -> bf16, x deq, + b, x alpha, each computed in f32 and
//     rounded with __float2bfloat16_rn; then round half to even and clip.
//     (deq and b carry the folded 127 / s_out; s_out is unused.)
// alpha == NULL means no PReLU (alpha = 1, conv_last's int8 sink).
//   mode 2 (bf16_deq), the int8 RRDB chain's stage conv
//     (image_restoration_tpu/ops/rrdb_quant.py:153-169): out is bf16,
//     acc -> f32 -> bf16, x deq, + b when bias is not NULL, each rounded to
//     bf16; no activation, no round, no clip. 345 launches per RRDBNet-23
//     forward (23 blocks x 3 dense blocks x 5 stages, Cin 64 -> Cout 192 and
//     Cin 32 -> Cout 160, 128, 96, 64). bias is NULL except at stage 0.
//
// Bound: operations. A packed body layer at the served shape is 1.64e11
// int8 multiply-adds against 2.9e8 bytes of input, weights and output, about
// 1100 operations per byte, far above the card's ~590 int8 operations per
// byte of memory rate; the least time is 3.29e11 operations over the
// 1979 Tops/s of the int8 tensor cores, 0.166 ms. This first kernel does not
// reach the tensor cores: it runs __dp4a (four int8 products summed into an
// int32 per instruction) on the CUDA cores, whose peak is a small fraction of
// the tensor cores'. What the design does within that: each block computes a
// 4 x 32 pixel x 64 output-channel tile, staging the input rows with their
// halo and the block's weights in shared memory 32 input channels at a time;
// each thread keeps a 4 pixel x 8 channel register tile of int32 sums, so one
// shared-memory word of input feeds 8 dp4a and one of weights feeds 4. The
// input is laid out [row][channel word][column] so a warp's 32 columns hit 32
// banks; the weights [tap][channel word][out channel] so a warp reads one
// broadcast address. mma.sync on s8 or wgmma is the later step.
//
// C interface (loaded with ctypes): int8_conv3x3_requant returns
// cudaGetLastError() after the launch, 0 on success, or cudaErrorInvalidValue
// for arguments it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTH = 4;                  // output rows per block (per thread)
constexpr int kTW = 32;                 // output columns per block (one per lane)
constexpr int kOCT = 8;                 // output channels per thread
constexpr int kCO = 64;                 // output channels per block
constexpr int kKW = 8;                  // input-channel words per stage (32 channels)
constexpr int kThreads = kTW * (kCO / kOCT);  // 256
constexpr int kInRows = kTH + 2;
constexpr int kInCols = kTW + 2;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_param(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float load_param(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
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

template <typename P, int kMode>
__global__ void __launch_bounds__(kThreads)
int8_conv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const P* __restrict__ deq, const P* __restrict__ bias,
                    const P* __restrict__ alpha, float s_out,
                    void* __restrict__ out, int hin, int win, int cin, int cout,
                    int hout, int wout, int pad, int co_blocks, bool vec_store) {
  __shared__ int s_in[kInRows * kKW * kInCols];            // [row][word][col]
  __shared__ __align__(16) int s_w[9 * kKW * kCO];         // [tap][word][out]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int og = tid >> 5;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z % co_blocks) * kCO;
  const int cw = cin >> 2;  // int32 words (4 channels each) per pixel
  const int* __restrict__ xw =
      reinterpret_cast<const int*>(x) + (int64_t)n * hin * win * cw;
  const int* __restrict__ ww = reinterpret_cast<const int*>(w);

  int acc[kTH][kOCT];
#pragma unroll
  for (int j = 0; j < kTH; ++j)
#pragma unroll
    for (int m = 0; m < kOCT; ++m) acc[j][m] = 0;

  for (int k0 = 0; k0 < cw; k0 += kKW) {
    // Input rows y0-pad .. y0-pad+kTH+1 and columns x0-pad .. x0-pad+kTW+1,
    // words k0 .. k0+kKW-1; zero outside the image and past Cin.
    for (int i = tid; i < kInRows * kInCols * kKW; i += kThreads) {
      const int k = i % kKW;
      const int c = (i / kKW) % kInCols;
      const int r = i / (kKW * kInCols);
      const int iy = y0 - pad + r, ix = x0 - pad + c, kk = k0 + k;
      int v = 0;
      if (iy >= 0 && iy < hin && ix >= 0 && ix < win && kk < cw)
        v = __ldg(xw + ((int64_t)iy * win + ix) * cw + kk);
      s_in[(r * kKW + k) * kInCols + c] = v;
    }
    // Weights of out channels co0 .. co0+kCO-1, all taps, words k0 ..;
    // zero past Cout and Cin.
    for (int i = tid; i < kCO * 9 * kKW; i += kThreads) {
      const int o = i % kCO;
      const int tk = i / kCO;  // tap * kKW + word
      const int k = tk % kKW, tap = tk / kKW;
      const int oo = co0 + o, kk = k0 + k;
      int v = 0;
      if (oo < cout && kk < cw) v = __ldg(ww + ((int64_t)oo * 9 + tap) * cw + kk);
      s_w[tk * kCO + o] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const int* si = s_in + dy * kKW * kInCols + lane + dx;
      const int* sw = s_w + tap * kKW * kCO + og * kOCT;
#pragma unroll
      for (int k = 0; k < kKW; ++k) {
        int xv[kTH];
#pragma unroll
        for (int j = 0; j < kTH; ++j) xv[j] = si[(j * kKW + k) * kInCols];
        const int4 wa = *reinterpret_cast<const int4*>(sw + k * kCO);
        const int4 wb = *reinterpret_cast<const int4*>(sw + k * kCO + 4);
        const int wv[kOCT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int j = 0; j < kTH; ++j)
#pragma unroll
          for (int m = 0; m < kOCT; ++m) acc[j][m] = __dp4a(xv[j], wv[m], acc[j][m]);
      }
    }
    __syncthreads();
  }

  const int ob = co0 + og * kOCT;
  if (ob >= cout) return;
  float pd[kOCT], pb[kOCT], pa[kOCT];
#pragma unroll
  for (int m = 0; m < kOCT; ++m) {
    const int o = min(ob + m, cout - 1);
    pd[m] = load_param(deq, o);
    pb[m] = bias != nullptr ? load_param(bias, o) : 0.f;
    pa[m] = alpha != nullptr ? load_param(alpha, o) : 1.f;
  }
  const bool prelu = alpha != nullptr;
  const float ratio = __fdiv_rn(127.f, s_out);
  const int xo = x0 + lane;
#pragma unroll
  for (int j = 0; j < kTH; ++j) {
    const int yo = y0 + j;
    if (yo >= hout || xo >= wout) continue;
    const int64_t at = (((int64_t)n * hout + yo) * wout + xo) * cout + ob;
    if constexpr (kMode == 2) {
      __align__(16) __nv_bfloat16 v[kOCT];
#pragma unroll
      for (int m = 0; m < kOCT; ++m)
        v[m] = dequant_bf16(acc[j][m], pd[m], pb[m], bias != nullptr);
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + at;
      if (vec_store && ob + kOCT <= cout) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      } else {
#pragma unroll
        for (int m = 0; m < kOCT; ++m)
          if (ob + m < cout) dst[m] = v[m];
      }
      continue;
    }
    int8_t q[kOCT];
#pragma unroll
    for (int m = 0; m < kOCT; ++m)
      q[m] = kMode == 1 ? requant_bf16(acc[j][m], pd[m], pb[m], pa[m], prelu)
                        : requant_f32(acc[j][m], pd[m], pb[m], pa[m], prelu, ratio);
    int8_t* dst = static_cast<int8_t*>(out) + at;
    if (vec_store && ob + kOCT <= cout) {
      uint2 v;
      v.x = (uint32_t)(uint8_t)q[0] | ((uint32_t)(uint8_t)q[1] << 8) |
            ((uint32_t)(uint8_t)q[2] << 16) | ((uint32_t)(uint8_t)q[3] << 24);
      v.y = (uint32_t)(uint8_t)q[4] | ((uint32_t)(uint8_t)q[5] << 8) |
            ((uint32_t)(uint8_t)q[6] << 16) | ((uint32_t)(uint8_t)q[7] << 24);
      *reinterpret_cast<uint2*>(dst) = v;
    } else {
#pragma unroll
      for (int m = 0; m < kOCT; ++m)
        if (ob + m < cout) dst[m] = q[m];
    }
  }
}

}  // namespace

// mode: 0 = f32 epilogue (deq/bias/alpha float32, s_out used), int8 out;
//       1 = bf16 epilogue (deq/bias/alpha bfloat16, s_out unused), int8 out;
//       2 = bf16_deq (deq/bias bfloat16, bias may be NULL, alpha must be
//           NULL, s_out unused), bf16 out.
// alpha may be NULL (no PReLU). pad is 0 or 1.
extern "C" int int8_conv3x3_requant(const void* x, const void* w, const void* deq,
                                    const void* bias, const void* alpha, float s_out,
                                    void* out, int n, int hin, int win, int cin,
                                    int cout, int pad, int mode, void* stream) {
  const int hout = hin + 2 * pad - 2, wout = win + 2 * pad - 2;
  if (n <= 0 || cin <= 0 || cin % 4 != 0 || cout <= 0 || (pad != 0 && pad != 1) ||
      hout <= 0 || wout <= 0 || mode < 0 || mode > 2 ||
      (mode != 2 && bias == nullptr) || (mode == 2 && alpha != nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int co_blocks = (cout + kCO - 1) / kCO;
  const long long gy = (hout + kTH - 1) / kTH, gz = (long long)n * co_blocks;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((wout + kTW - 1) / kTW, (unsigned)gy, (unsigned)gz);
  // 8 channels per store: 8 bytes of int8, 16 bytes of bf16
  const bool vec_store = cout % kOCT == 0 &&
      reinterpret_cast<uintptr_t>(out) % (mode == 2 ? 16 : 8) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(deq);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(bias);
  const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(alpha);
  if (mode == 0) {
    int8_conv3x3_kernel<float, 0><<<grid, kThreads, 0, s>>>(
        xi, wi, static_cast<const float*>(deq), static_cast<const float*>(bias),
        static_cast<const float*>(alpha), s_out, out, hin, win, cin, cout, hout,
        wout, pad, co_blocks, vec_store);
  } else if (mode == 1) {
    int8_conv3x3_kernel<__nv_bfloat16, 1><<<grid, kThreads, 0, s>>>(
        xi, wi, db, bb, ab, s_out, out, hin, win, cin, cout, hout, wout, pad,
        co_blocks, vec_store);
  } else {
    int8_conv3x3_kernel<__nv_bfloat16, 2><<<grid, kThreads, 0, s>>>(
        xi, wi, db, bb, nullptr, s_out, out, hin, win, cin, cout, hout, wout,
        pad, co_blocks, vec_store);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* int8_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
