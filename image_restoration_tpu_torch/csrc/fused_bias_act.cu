// Fused bias + LeakyReLU x scale for Hopper (sm_90a).
//
// Replaces the TPU kernel image_restoration_tpu/ops/pallas/fused_act_kernel.py
// `fused_bias_lrelu_pallas`:
//     o = (x + b >= 0 ? x + b : (x + b) * slope) * scale
// over the dense (M, C) row-major view of a contiguous channel-last tensor,
// with the bias indexed by i % C. It runs after every ConvLayer, StyleConv and
// activated ConvUpLayer of GFPGANv1OCR (39 launches per 256^2 forward).
//
// Bound: bytes. Each element is read once and written once (8 bytes in f32,
// 4 in bf16) against three floating-point operations, far below the card's
// ~20 operations per byte for f32 CUDA cores, so the least time is the bytes
// over the memory rate. The design does the simple thing about it: a
// grid-stride loop with 16-byte vector loads and stores (float4 in f32, eight
// bf16 in bf16) where C and the pointers allow, a scalar loop otherwise; the
// ragged tail needs no mask beyond the loop bound. Arithmetic is f32, the
// store rounds once to the tensor's type. Making it fast is later work:
// fusing it into the producing convolution's epilogue removes its pass over
// device memory altogether.
//
// C interface (loaded with ctypes): fused_bias_lrelu returns the value of
// cudaGetLastError() after the launch; 0 means success. It launches on the
// given stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Two waves of the 8 blocks of 256 threads that an H100 SM (2048 threads)
// holds at once, on each of its 132 SMs; larger tensors loop.
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float lrelu_scale(float v, float slope, float scale) {
  return (v >= 0.f ? v : v * slope) * scale;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// One element per step; any C, any alignment.
template <typename T>
__global__ void fused_bias_lrelu_scalar(const T* __restrict__ x,
                                        const T* __restrict__ bias,
                                        T* __restrict__ out, int64_t n, int c,
                                        float slope, float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = to_f32(x[i]);
    if (bias != nullptr) v += to_f32(bias[i % c]);
    out[i] = from_f32<T>(lrelu_scale(v, slope, scale));
  }
}

// 16 bytes per step: VEC = 16 / sizeof(T) elements that share one row, since
// C % VEC == 0 and every step starts at a multiple of VEC.
template <typename T>
__global__ void fused_bias_lrelu_vec16(const T* __restrict__ x,
                                       const T* __restrict__ bias,
                                       T* __restrict__ out, int64_t nvec, int c,
                                       float slope, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < nvec;
       j += stride) {
    uint4 raw = xv[j];
    const T* e = reinterpret_cast<const T*>(&raw);
    const int ch = (int)((j * VEC) % c);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float v = to_f32(e[k]);
      if (bias != nullptr) v += to_f32(bias[ch + k]);
      r[k] = from_f32<T>(lrelu_scale(v, slope, scale));
    }
    ov[j] = res;
  }
}

template <typename T>
void launch(const void* x, const void* bias, void* out, int64_t n, int c,
            float slope, float scale, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t work = (aligned && c % VEC == 0) ? n / VEC : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (aligned && c % VEC == 0) {
    fused_bias_lrelu_vec16<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, bt, ot, work, c, slope, scale);
  } else {
    fused_bias_lrelu_scalar<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, bt, ot, work, c, slope, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be NULL (no bias).
extern "C" int fused_bias_lrelu(const void* x, const void* bias, void* out,
                                long long n, int c, float slope, float scale,
                                int dtype, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, bias, out, n, c, slope, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, bias, out, n, c, slope, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fused_bias_lrelu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
