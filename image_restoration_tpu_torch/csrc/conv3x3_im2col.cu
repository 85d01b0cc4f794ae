// 3x3 stride-1 VALID convolution over a pre-padded NHWC input as an implicit
// GEMM on the bf16 tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel image_restoration_tpu/ops/pallas/im2col_conv.py
// `conv3x3_im2col` (body `_kernel`): per row block it copies a (bh*W, 9*Cin)
// im2col matrix into VMEM and issues one K = 9*Cin dot with f32 accumulation.
//     out[n,y,x,o] = sum_{dy,dx,c} x[n,y+dy,x+dx,c] * w[dy,dx,c,o]
// bf16 inputs and weights, products and sums in f32, bf16 or f32 output. Its
// path is the probe of the widened RRDB stage convs
// (image_restoration_tpu_torch/scripts/probe_conv.py): Cin 64 -> Cout 192 and
// Cin 32 -> Cout 160, 128, 96, 64, at 528^2.
//
// Layout: x (N, H+2, W+2, Cin) bf16, Cin a multiple of 16 and at most 128
// (the wrapper pads); w (9*Cin, Cout_w) bf16, the HWIO weight flattened,
// Cout_w >= Cout a multiple of 8 (the wrapper pads); out (N, H, W, Cout).
//
// Bound: at 528^2 the 64->192 stage does 6.2e10 flops against 1.4e8 bytes of
// bf16 input and output (weights 0.2 MB): about 430 flops per byte, above
// the ~295 at which the bf16 tensor cores (989 Tflop/s) and not the memory
// (3.35 TB/s) are the limit, so it is bounded by operations (0.062 ms). The
// four Cin = 32 stages do 576*Cout flops per pixel against 64 + 2*Cout bytes,
// 190-240 flops per byte: below that line, so bounded by bytes.
//
// Design (a right, simple first kernel; no TMA, no wgmma yet): a block owns
// 8 output rows x 16 columns x 64 output channels per tile, and walks up to 4
// tiles along x with the block's weights resident. It stages the
// (9*Cin) x 64 weight slice once and, per tile, the 10 x 18 x Cin input slab
// in shared memory with cp.async (zero-filled outside the image and past
// Cout_w). The im2col matrix is never built: each 16-pixel output row is one
// m16 fragment, and ldmatrix reads its A rows straight from the slab at the
// tap's (dy, dx) offset - an implicit GEMM. 8 warps each own 2 rows x 32
// channels and issue mma.sync m16n8k16 bf16 -> f32. Shared-memory rows are
// padded by 16 bytes so the 8 row addresses of an ldmatrix hit 8 distinct
// bank groups. The epilogue writes each thread's pairs of channels straight
// from registers, masked at the ragged rows, columns and Cout.
//
// C interface (loaded with ctypes): conv3x3_im2col returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for arguments it
// does not take. It launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;              // output rows per tile
constexpr int kTW = 16;             // output columns per tile (one m16 fragment)
constexpr int kBN = 64;             // output channels per block
constexpr int kThreads = 256;       // 8 warps: 4 along rows x 2 along channels
constexpr int kTilesPerBlock = 4;   // tiles along x that share the staged weights
constexpr int kSlabRows = kTH + 2;
constexpr int kSlabCols = kTW + 2;
constexpr int kWStride = kBN + 8;   // bf16 per staged weight row
constexpr int kMaxCin = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring channels o, o+1 of one pixel (o + 1 may lie past Cout).
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b,
                                           bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (both) p[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b, bool both,
                                           bool vec) {
  if (both && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_im2col_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w, OutT* __restrict__ out,
                      int h, int wd, int cin, int cout, int cout_w, int co_blocks,
                      int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ps = cin + 8;  // bf16 per staged pixel
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);  // [9*cin][kWStride]
  __nv_bfloat16* s_x = s_w + 9 * cin * kWStride;                // [row][col][ps]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // output rows 2*wm, 2*wm + 1 of the tile
  const int wn = warp >> 2;  // output channels 32*wn .. 32*wn + 31 of the block
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z % co_blocks) * kBN;
  const int y0 = blockIdx.y * kTH;
  const int hp = h + 2, wp = wd + 2;
  const int chunks = cin / 8;  // 16-byte chunks per pixel
  const __nv_bfloat16* xn = x + (int64_t)n * hp * wp * cin;

  // The block's weights: rows k = (dy*3 + dx)*cin + c, columns co0 .. co0+63.
  for (int i = tid; i < 9 * cin * (kBN / 8); i += kThreads) {
    const int q = i % (kBN / 8), k = i / (kBN / 8);
    const int col = co0 + q * 8;
    const bool valid = col < cout_w;
    cp_async16(smem_u32(s_w + k * kWStride + q * 8),
               valid ? w + (int64_t)k * cout_w + col : w, valid);
  }

  // ldmatrix row addresses. A (16 pixels x 16 channels): lane -> pixel
  // (lane & 7) + 8*((lane >> 3) & 1), channel offset 8*(lane >> 4), so the
  // four 8x8 matrices are mma's a0..a3. B (16 k x 16 out channels, stored
  // k-major, read transposed): lane -> k row (lane & 7) + 8*((lane >> 3) & 1),
  // channel offset 8*(lane >> 4): b0, b1 of two n8 tiles.
  const int a_pix = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_ch = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_n = wn * 32 + (lane >> 4) * 8;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row and column pair
  const bool vec = (cout & 1) == 0;

  const int t_begin = blockIdx.x * kTilesPerBlock;
  const int t_end = min(t_begin + kTilesPerBlock, tiles_x);
  for (int t = t_begin; t < t_end; ++t) {
    const int x0 = t * kTW;
    if (t != t_begin) __syncthreads();  // every warp is done with the last slab
    for (int i = tid; i < kSlabRows * kSlabCols * chunks; i += kThreads) {
      const int q = i % chunks, pix = i / chunks;
      const int iy = y0 + pix / kSlabCols, ix = x0 + pix % kSlabCols;
      const bool valid = iy < hp && ix < wp;
      cp_async16(smem_u32(s_x + pix * ps + q * 8),
                 valid ? xn + ((int64_t)iy * wp + ix) * cin + q * 8 : x, valid);
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      uint32_t a_addr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a_addr[i] = smem_u32(s_x + ((wm * 2 + i + dy) * kSlabCols + a_pix + dx) * ps +
                             a_ch);
      const uint32_t b_addr = smem_u32(s_w + (tap * cin + b_k) * kWStride + b_n);
#pragma unroll 2
      for (int c0 = 0; c0 < cin; c0 += 16) {
        uint32_t a[2][4], b[2][4];
        ldmatrix_x4(a[0], a_addr[0] + c0 * 2);
        ldmatrix_x4(a[1], a_addr[1] + c0 * 2);
        ldmatrix_x4_trans(b[0], b_addr + c0 * kWStride * 2);
        ldmatrix_x4_trans(b[1], b_addr + (c0 * kWStride + 16) * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                     b[j >> 1][(j & 1) * 2 + 1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int y = y0 + wm * 2 + i;
      if (y >= h) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = co0 + wn * 32 + j * 8 + tq * 2;
        if (o >= cout) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int xo = x0 + g + half * 8;
          if (xo >= wd) continue;
          store_pair(out + (((int64_t)n * h + y) * wd + xo) * cout + o,
                     acc[i][j][half * 2], acc[i][j][half * 2 + 1], o + 1 < cout, vec);
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, void* out, int n, int h, int wd,
                   int cin, int cout, int cout_w, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
      (size_t)(9 * cin * kWStride + kSlabRows * kSlabCols * (cin + 8));
  static size_t smem_allowed = 48 * 1024;  // dynamic shared memory without opt-in
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_im2col_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  const int co_blocks = (cout + kBN - 1) / kBN;
  const int tiles_x = (wd + kTW - 1) / kTW;
  const dim3 grid((tiles_x + kTilesPerBlock - 1) / kTilesPerBlock,
                  (h + kTH - 1) / kTH, n * co_blocks);
  conv3x3_im2col_kernel<OutT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<OutT*>(out), h, wd, cin, cout, cout_w, co_blocks, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// x (n, h+2, wd+2, cin) bf16; w (9*cin, cout_w) bf16; out (n, h, wd, cout),
// float32 if out_f32 else bf16.
extern "C" int conv3x3_im2col(const void* x, const void* w, void* out, int n, int h,
                              int wd, int cin, int cout, int cout_w, int out_f32,
                              void* stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cin % 16 != 0 || cin > kMaxCin ||
      cout <= 0 || cout_w < cout || cout_w % 8 != 0 || align % 16 != 0 ||
      (h + kTH - 1) / kTH > 65535 || (long long)n * ((cout + kBN - 1) / kBN) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_f32 ? launch<float>(x, w, out, n, h, wd, cin, cout, cout_w, s)
              : launch<__nv_bfloat16>(x, w, out, n, h, wd, cin, cout, cout_w, s);
  return (int)e;
}

extern "C" const char* conv3x3_im2col_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
