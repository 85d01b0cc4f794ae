// 3x3 stride-1 VALID convolution over a pre-padded NHWC input as an implicit
// GEMM on Hopper's bf16 tensor cores (wgmma), for sm_90a.
//
// Replaces the TPU kernel image_restoration_tpu/ops/pallas/im2col_conv.py
// `conv3x3_im2col` (body `_kernel`): per row block it copies a (bh*W, 9*Cin)
// im2col matrix into VMEM and issues one K = 9*Cin dot with f32 accumulation.
//     out[n,y,x,o] = sum_{dy,dx,c} x[n,y+dy,x+dx,c] * w[dy,dx,c,o]
// bf16 inputs and weights, products and sums in f32, bf16 or f32 output. Its
// path is the probe of the widened RRDB stage convs
// (image_restoration_tpu_torch/scripts/probe_conv.py).
//
// Layout: x (N, H+2, W+2, Cin) bf16, Cin a multiple of 16 and at most 128
// (the wrapper pads); w (9*Cin, Cout_w) bf16, the HWIO weight flattened,
// Cout_w >= Cout a multiple of 8 (the wrapper pads); out (N, H, W, Cout).
//
// Bounds at the probe's stages (one 528^2 image, bf16 in and out; H100 SXM:
// 989 Tflop/s bf16, 3.35 TB/s):
//   64 -> 192  0.06235 ms, operations (6.17e10 flop)
//   32 -> 160  0.03202 ms, bytes (107.3 MB)
//   32 -> 128  0.02669 ms, bytes (89.4 MB)
//   32 -> 96   0.02136 ms, bytes (71.6 MB)
//   32 -> 64   0.01603 ms, bytes (53.7 MB)
// At Cin 32 the output (2 * Cout bytes a pixel against 64 in) is most of it.
//
// Design. GEMM view: M = output pixels, N = Cout, K = 9 taps x Cin.
// - wgmma m64nNTk16 .f32.bf16.bf16 with A and B from shared memory through
//   descriptors. Tiles of 8 rows x 24 columns; three warpgroups each own an
//   8 x 8 part (M = 64) and its 10 x 10 input slab (halo included, zero past
//   the image), stored without swizzle as [16-byte channel chunk][row]
//   [column]: for every tap the part's 64 A rows are core matrices of 8
//   pixels x 8 channels, one slab row apart (SBO = 10 x 16 bytes), the next
//   8 channels one chunk plane further (LBO), so a tap only moves the
//   descriptor's start address by (dy * 10 + dx) x 16 bytes. No im2col copy.
// - B is the weight as the wrapper passes it, (9*Cin, Cout_w): N-major. TMA
//   copies it as it is, in boxes of 32 channels x 144 k rows with a 64-byte
//   swizzle, to [NT / 32][9 * Cin][64 bytes], and wgmma reads it transposed
//   (imm-trans-b = 1, legal for bf16) through a 64-byte-swizzle descriptor:
//   neither the wrapper nor the kernel transposes it.
// - Weights resident, persistent grid. A block keeps one slice of NT output
//   channels for its whole life: NT is the widest of 160, 128, ..., 32 whose
//   weights fit in shared memory beside the slabs and staging tiles, then
//   narrowed to split Cout evenly (Cin 32: NT = Cout up to 160, the input
//   read once and no MMA column wasted at Cout 160; Cin 64 -> 192: two
//   slices of 96; Cin 128: 32). NT = 192 is left out: at 96 accumulators a
//   thread, ptxas spilled or fenced the wgmma. The grid's blocks are split
//   evenly over the slices, and those of every slice walk the spatial tiles
//   in the same order, so a slab one reads is in L2 for the others.
// - Slabs come by TMA: a 4-D tensor map over x (Cin, W+2, H+2, N) with
//   boxes of (8 channels, 10 columns, 10 rows, 1 image); each box lands one
//   chunk plane [row][column][16 bytes], exactly what the descriptors read,
//   and the hardware zero-fills past the edge. One thread of a warpgroup
//   issues its Cin/8 boxes on the warpgroup's mbarrier. Each warpgroup has
//   two slab buffers where shared memory holds them (one at Cin 128), so
//   the slab of its tile after next loads while it computes.
// - The warpgroups take turns on the tensor cores in a ring of named
//   barriers (the design of int8_conv3x3.cu): while one runs its 9 x Cin/16
//   wgmma, the other two run their epilogues and stores. The tap and chunk
//   loops are unrolled, so the wgmma issue back to back.
// - Epilogue: bf16 out goes through a staging tile in shared memory (rows
//   padded by 16 bytes against bank conflicts) and leaves as 16-byte rows of
//   contiguous channels, masked at H, W and Cout; f32 out (tests, ragged
//   shapes) is stored straight from the accumulator registers.
// Dynamic shared memory (smem_bytes; ptxas reports none) at the probe's
// stages: 230,456 bytes at 64 -> 192 (NT 96), 196,664 / 165,944 / 135,224
// / 104,504 at 32 -> 160 / 128 / 96 / 64, all with two slab buffers.
// What decided the design, from chip_smoke.py phase 11 on an H100 80GB
// HBM3 at 700 W (ms per pass of the five stages, both in one run):
//   slab loads: TMA 0.31573 / 0.31512 against 0.37568 / 0.37587 for slabs
//   copied by the threads with cp.async (one buffer a warpgroup): TMA kept;
//   two slab buffers a warpgroup then gave 0.28992 / 0.28947.
// The weights were first staged by the threads in 16-byte cp.async copies,
// core matrix by core matrix; every block loading its slice at once made
// that most of a launch's fixed cost, which 64-byte TMA boxes cut (the
// run's numbers are in PERF.md).
//
// C interface (loaded with ctypes): conv3x3_im2col returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for arguments it
// does not take. It launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWgs = 3;                 // warpgroups, one 8 x 8 part of a tile each
constexpr int kTH = 8;                  // output rows per tile
constexpr int kPartW = 8;               // columns of a warpgroup's part
constexpr int kTW = kWgs * kPartW;      // 24 output columns per tile
constexpr int kWgPix = kTH * kPartW;    // 64: wgmma's M
constexpr int kThreads = 128 * kWgs;
constexpr int kSlabCols = kPartW + 2;
constexpr int kSlabPix = (kTH + 2) * kSlabCols;  // 100
constexpr int kPlane = 1664;  // one chunk plane of a slab: 100 x 16 bytes, padded to 128
constexpr int kWBoxRows = 144;          // k rows of a weight box (9 * 16)
constexpr int kMaxCin = 128;
constexpr int kMaxNT = 160;
constexpr int kMaxBufs = 2;             // slab buffers per warpgroup
constexpr size_t kMaxSmem = 232448;     // H100: per block, opt-in

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a tensor map into shared memory, completing on the mbarrier;
// the box's parts past the tensor are zero.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address and the two strides
// between core matrices or swizzle atoms (LBO, SBO), in 16-byte units, and
// the swizzle (0 none, 2 64-byte). A descriptor plus (bytes >> 4) moves its
// start.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// m64nNk16 f32 += bf16 x bf16, A (K-major) and B (N-major, imm-trans-b = 1)
// from shared memory; d holds N / 2 sums.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Keeps the compiler from moving accumulator accesses across wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

struct Args {
  void* out;
  int h, wd, cin, cout;
  int tiles_x, tiles_img, tiles_sp;  // spatial tiles: per row, per image, all
  int slices, per_slice;             // output-channel slices; blocks per slice
  int bufs;                          // slab buffers per warpgroup, 1 or 2
  bool out_f32;
  bool vec_store;                    // 16-byte stores of the staged tile
};

// Barrier ids: 0 is __syncthreads; 1 + w warpgroup w's own; 1 + kWgs + w
// hands the tensor cores to warpgroup w.
constexpr int kBarWg = 1;
constexpr int kBarTurn = 1 + kWgs;

// weights, slabs, staging tiles, one mbarrier per slab buffer and one for
// the weights
size_t smem_bytes(int nt, int cin, int bufs) {
  return (size_t)9 * cin * nt * 2 + (size_t)kWgs * bufs * (cin / 8) * kPlane +
         (size_t)kWgs * kWgPix * (2 * nt + 16) + (size_t)(kWgs * bufs + 1) * sizeof(uint64_t);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma(const Args a, const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int pitch = 2 * NT + 16;           // staged output row, bytes
  const int chunks = a.cin / 8;                // 16-byte channel chunks per pixel
  const int steps = a.cin / 16;                // k16 steps per tap
  const int tid = threadIdx.x;
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: tile columns 8*wg .. 8*wg + 7
  const int wq = warp & 3;   // rows 2*wq, 2*wq + 1 of its M = 64
  const int w_bytes = 9 * a.cin * NT * 2;
  const int slab_bytes = chunks * kPlane;
  unsigned char* s_w = smem;  // [NT / 32][9 * cin][64 bytes, swizzled]
  // per warpgroup: its slab buffers [chunks][10 rows][10 columns][16 bytes],
  // its staging tile [64 pixels][pitch] and one mbarrier per buffer
  unsigned char* s_slab = smem + w_bytes + wg * a.bufs * slab_bytes;
  unsigned char* s_out = smem + w_bytes + kWgs * a.bufs * slab_bytes + wg * kWgPix * pitch;
  const uint32_t bar0 =
      smem_u32(smem + w_bytes + kWgs * a.bufs * slab_bytes + kWgs * kWgPix * pitch);
  const uint32_t bars = bar0 + wg * a.bufs * 8;
  const uint32_t wbar = bar0 + kWgs * a.bufs * 8;
  const int co0 = blockIdx.x % a.slices * NT;

  // Spatial tile r: image, first output row, this warpgroup's first column.
  auto origin = [&](int r, int& img, int& y0, int& x0) {
    img = r / a.tiles_img;
    const int rr = r - img * a.tiles_img;
    y0 = rr / a.tiles_x * kTH;
    x0 = rr % a.tiles_x * kTW + wg * kPartW;
  };
  // This warpgroup's input slab of tile r into buffer b: rows y0 .. y0+9,
  // columns x0 .. x0+9 of the padded input, zero past it.
  auto load_slab = [&](int r, int b) {
    if (wtid != 0) return;
    int img, y0, x0;
    origin(r, img, y0, x0);
    const uint32_t dst = smem_u32(s_slab) + b * slab_bytes, bar = bars + 8 * b;
    mbar_expect_tx(bar, chunks * kSlabPix * 16);
    for (int c = 0; c < chunks; ++c) tma_load_4d(dst + c * kPlane, &xmap, bar, 8 * c, x0, y0, img);
  };

  // The block's weight slice, output channels co0 .. co0+NT-1 (zero past
  // Cout_w), in boxes of 32 channels x 144 k rows.
  if (tid == 0) {
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(wbar, w_bytes);
    for (int j = 0; j < NT / 32; ++j)
      for (int k0 = 0; k0 < 9 * a.cin; k0 += kWBoxRows)
        tma_load_2d(smem_u32(s_w) + (j * 9 * a.cin + k0) * 64, &wmap, wbar, co0 + 32 * j, k0);
  }
  if (wtid == 0) {
    for (int b = 0; b < a.bufs; ++b) mbar_init(bars + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int r0 = blockIdx.x / a.slices;
  for (int b = 0; b < a.bufs; ++b)
    if (r0 + b * a.per_slice < a.tiles_sp) load_slab(r0 + b * a.per_slice, b);
  __syncthreads();  // the mbarriers are initialised
  mbar_wait(wbar, 0);

  const int g = lane >> 2, q = lane & 3;  // accumulator row and column pair
  const uint64_t da0 = make_desc(smem_u32(s_slab), kPlane, kSlabCols * 16, 0);
  // B: 64-byte swizzle atoms of 8 k rows x 32 channels (512 bytes); the next
  // 8 rows one atom further (SBO), the next 32 channels one column block
  // further (LBO = 9 * Cin * 64 bytes).
  const uint64_t db0 = make_desc(smem_u32(s_w), 9 * a.cin * 64, 512, 2);
  // The warpgroups walk the same tiles, each its 8 x 8 part, and take turns
  // on the tensor cores in a ring: while one runs its wgmma, the others run
  // their epilogues and stores.
  for (int it = 0, r = r0; r < a.tiles_sp; ++it, r += a.per_slice) {
    const bool more = r + a.per_slice < a.tiles_sp;
    const int b = a.bufs == 1 ? 0 : it & 1;
    mbar_wait(bars + 8 * b, (a.bufs == 1 ? it : it >> 1) & 1);
    if (wg != 0 || it > 0) bar_sync(kBarTurn + wg, 256);

    // Every wgmma's descriptors are these plus an offset; the empty asm
    // keeps the compiler from holding all 2 x 9 x Cin/16 of them (or their
    // offsets) in registers across tiles.
    uint64_t da = da0 + (uint64_t)(b * slab_bytes >> 4), db = db0;
    int cin4 = a.cin * 4;  // 16-byte units between taps in B
    asm volatile("" : "+l"(da), "+l"(db), "+r"(cin4));
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kMaxCin / 16; ++s) {
      if (s >= steps) break;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * dy;
        Wgmma<NT>::mma(acc, da + (dy * kSlabCols + dx) + s * (2 * kPlane >> 4),
                       db + tap * cin4 + 64 * s);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (wg < kWgs - 1) bar_arrive(kBarTurn + wg + 1, 256);
    else if (more) bar_arrive(kBarTurn, 256);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // every warp's wgmma are done with the slab and every warp has stored
    // the last staged tile: the buffer takes the tile after next
    bar_sync(kBarWg + wg, 128);
    if (r + a.bufs * a.per_slice < a.tiles_sp) load_slab(r + a.bufs * a.per_slice, b);

    // Fragment j holds channels 8j + 2q, 8j + 2q + 1 of rows 2*wq (h = 0)
    // and 2*wq + 1 (h = 1) of the part, column g.
    int img, y0, x0;
    origin(r, img, y0, x0);
    if (a.out_f32) {
      float* outf = static_cast<float*>(a.out);
      const bool pair = (a.cout & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = y0 + 2 * wq + h, xo = x0 + g;
        if (y >= a.h || xo >= a.wd) continue;
        float* row = outf + (((int64_t)img * a.h + y) * a.wd + xo) * a.cout;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int o = co0 + 8 * j + 2 * q;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (o + 1 < a.cout && pair) {
            *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
          } else if (o < a.cout) {
            row[o] = v0;
            if (o + 1 < a.cout) row[o + 1] = v1;
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(s_out + ((2 * wq + h) * kPartW + g) * pitch +
                                           (8 * j + 2 * q) * 2) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    bar_sync(kBarWg + wg, 128);

    // The staged part to the output, masked at H, W and Cout.
    __nv_bfloat16* outh = static_cast<__nv_bfloat16*>(a.out);
    if (a.vec_store) {
      // 16-byte rows of contiguous channels; all loads first, then stores
      constexpr int cpp = NT / 8;            // 16-byte chunks per staged pixel
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
        if (y >= a.h || xo >= a.wd || co0 + 8 * c >= a.cout) continue;
        const int64_t at = (((int64_t)img * a.h + y) * a.wd + xo) * a.cout + co0 + 8 * c;
        *reinterpret_cast<uint4*>(outh + at) = v[k];
      }
    } else {
      for (int i = wtid; i < kWgPix * NT; i += 128) {
        const int p = i / NT, o = i - p * NT;
        const int y = y0 + p / kPartW, xo = x0 + p % kPartW;
        if (y >= a.h || xo >= a.wd || co0 + o >= a.cout) continue;
        outh[(((int64_t)img * a.h + y) * a.wd + xo) * a.cout + co0 + o] =
            *reinterpret_cast<const __nv_bfloat16*>(s_out + p * pitch + o * 2);
      }
    }
  }
}

// Two slab buffers a warpgroup where shared memory holds them, else one;
// then the widest NT (a multiple of 32, at most 160) whose slice fits,
// narrowed so that ceil(Cout / NT) slices split Cout evenly. 0: none fits.
int pick_nt(int cin, int cout, int* bufs) {
  for (int b = kMaxBufs; b >= 1; --b) {
    for (int fit = kMaxNT; fit >= 32; fit -= 32) {
      if (smem_bytes(fit, cin, b) > kMaxSmem) continue;
      const int slices = (cout + fit - 1) / fit;
      const int per = (cout + slices - 1) / slices;
      *bufs = b;
      return (per + 31) / 32 * 32;
    }
  }
  return 0;
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

struct Maps {
  CUtensorMap x;  // (Cin, W+2, H+2, N), boxes of (8, 10, 10, 1)
  CUtensorMap w;  // (Cout_w, 9*Cin), boxes of (32, 144), 64-byte swizzle
};

// The call's two tensor maps, cached per pointers and shape so that a
// repeated call encodes nothing.
bool tensor_maps(Maps* maps, const void* x, const void* w, int n, int hp, int wp, int cin,
                 int cout_w) {
  struct Entry {
    const void* x;
    const void* w;
    int n, hp, wp, cin, cout_w;
    Maps maps;
  };
  constexpr int kEntries = 8;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.x == x && e.w == w && e.n == n && e.hp == hp && e.wp == wp && e.cin == cin &&
        e.cout_w == cout_w) {
      *maps = e.maps;
      return true;
    }
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  Entry e{x, w, n, hp, wp, cin, cout_w, {}};
  const cuuint64_t x_dims[4] = {(cuuint64_t)cin, (cuuint64_t)wp, (cuuint64_t)hp, (cuuint64_t)n};
  const cuuint64_t x_strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wp * cin * 2,
                                   (cuuint64_t)hp * wp * cin * 2};
  const cuuint32_t x_box[4] = {8, kSlabCols, kTH + 2, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)cout_w, (cuuint64_t)9 * cin};
  const cuuint64_t w_strides[1] = {(cuuint64_t)cout_w * 2};
  const cuuint32_t w_box[2] = {32, kWBoxRows};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(&e.maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), x_dims,
             x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS ||
      encode(&e.maps.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), w_dims,
             w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
          CUDA_SUCCESS)
    return false;
  cache[next] = e;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  *maps = e.maps;
  return true;
}

template <int NT>
cudaError_t launch(Args a, const Maps& maps, size_t smem, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma<NT>;
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
  // the persistent grid: as many blocks as fit on the card at once, split
  // evenly over the slices, and no more per slice than there are tiles
  int per_slice = sms * per_sm / a.slices;
  if (per_slice > a.tiles_sp) per_slice = a.tiles_sp;
  if (per_slice < 1) per_slice = 1;
  a.per_slice = per_slice;
  kernel<<<per_slice * a.slices, kThreads, smem, stream>>>(a, maps.x, maps.w);
  return cudaGetLastError();
}

}  // namespace

// x (n, h+2, wd+2, cin) bf16; w (9*cin, cout_w) bf16; out (n, h, wd, cout),
// float32 if out_f32 else bf16. cin is a multiple of 16 and at most 128,
// cout_w >= cout a multiple of 8, x and w 16-byte aligned.
extern "C" int conv3x3_im2col(const void* x, const void* w, void* out, int n, int h, int wd,
                              int cin, int cout, int cout_w, int out_f32, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cin % 16 != 0 || cin > kMaxCin ||
      cout <= 0 || cout_w < cout || cout_w % 8 != 0 || align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles_x = (wd + kTW - 1) / kTW, tiles_y = (h + kTH - 1) / kTH;
  const long long tiles_sp = (long long)n * tiles_y * tiles_x;
  int bufs = 1;
  const int nt = pick_nt(cin, cout, &bufs);
  if (nt == 0 || tiles_sp > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!tensor_maps(&maps, x, w, n, h + 2, wd + 2, cin, cout_w))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.out = out;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.tiles_x = (int)tiles_x;
  a.tiles_img = (int)(tiles_y * tiles_x);
  a.tiles_sp = (int)tiles_sp;
  a.slices = (cout + nt - 1) / nt;
  a.per_slice = 1;
  a.bufs = bufs;
  a.out_f32 = out_f32 != 0;
  a.vec_store = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t smem = smem_bytes(nt, cin, bufs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 160: return (int)launch<160>(a, maps, smem, s);
    case 128: return (int)launch<128>(a, maps, smem, s);
    case 96: return (int)launch<96>(a, maps, smem, s);
    case 64: return (int)launch<64>(a, maps, smem, s);
    default: return (int)launch<32>(a, maps, smem, s);
  }
}

extern "C" const char* conv3x3_im2col_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
