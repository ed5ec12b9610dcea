// Same-grid NHWC convolution for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel joint_vae_tpu/ops/pallas_conv.py
// (_same_grid_conv_impl / _kernel_body): a stride-(1,1) conv whose output
// grid equals its input grid, y[n,i,j,o] = sum_{a,b,c} x[n, i+a-ph_lo,
// j+b-pw_lo, c] * w[a,b,c,o] with zeros outside the image, pads
// (ph_lo, th-1-ph_lo) x (pw_lo, tw-1-pw_lo), possibly asymmetric.  No bias.
// x (n,h,w,ci) and w (th,tw,ci,co) are float32 or bfloat16, contiguous;
// y (n,h,w,co) is in the input type; accumulation is float32.  The model
// calls it at its stride-1 (de)convs and, through the sub-pixel lowering,
// at its stride-2 deconvs (3x3 packed taps to 4*co phase-packed channels);
// the input gradient is the same conv on the flipped kernel.
//
// What bounds it on this card: operations.  Each output value costs
// 2*taps*ci FLOPs (150-3,200 at the model's shapes) against a few bytes
// moved.  Float32 runs as 3xTF32: each operand v is split into big (v
// rounded to TF32) and small (v - big, cut to TF32), and the products
// small*big + big*small, then big*big, accumulate in float32 (one TF32
// pass keeps ~3 digits), so the bound is 3 * FLOPs / 495 TFLOP/s.
// bfloat16 is one pass at 989 TFLOP/s.  Only wgmma reaches those rates.
//
// What the design does about it (tc_conv_kernel): an implicit GEMM on
// wgmma.mma_async.  M is a band of 64 output pixels per warpgroup (two or
// four warpgroups), whole rows of the flattened n*h row grid (several 8x8
// images share a block).  N is co rounded up to 8..128.  K runs over
// units of 64 bytes of channels of one tap.  The tap shift is why A comes
// from registers: a tap's window is the staged band shifted by (a, b), and
// a row whose tap leaves its image reads a zero row instead, a choice of
// address per thread, as the TPU kernel masks its flat row shifts.  Each
// thread loads its two fragment rows with one 16-byte shared load each per
// unit; the unit's channels are ordered so that those 16 bytes are exactly
// the thread's fragment of two wgmma K steps (m64nNk8 .tf32 or m64nNk16
// .bf16), and the weights are staged in the same order.  B, the weights,
// is read by the tensor cores from shared memory through a descriptor.
// TF32 has no transposed form, so float32 weights are copied (cp.async,
// PD iterations ahead) into raw rows and then split into big and small
// K-major core matrices, once per stage; bf16 weights are copied as they
// are (8 co of one channel, 16 bytes) and read transposed (imm-trans-b).
// A is split once per loaded fragment.  The band of one channel chunk is
// staged with cp.async one chunk ahead (two slots).  Small ci (3 at
// conv_0's forward and conv_6's input gradient) folds the taps into K: a
// 16-byte unit per tap, four taps a unit.
//
// Where it does not win: with A in registers every fragment a thread
// loads and splits feeds only N columns, and each iteration ends in a
// barrier and a wait for its wgmma group.  At N = 32 that overhead and
// the weights re-read per 128-pixel tile outweigh wgmma's rate: timed in
// one call on the card, the mma.sync kernel below is faster there
// (PERF.md).
// So dispatch keeps mma_conv_kernel (below) for the non-folded co <= 32
// sites, and wgmma takes the folded sites and every co > 32 (four
// warpgroups).
//
// Precision: the tensor cores add a product sum into the accumulator with
// its low bits truncated.  So in float32 each iteration's products (32 a
// row at most) go into a fresh partial sum (scale-d = 0 on its first
// wgmma) that is added to the total, rounding to nearest, once the
// iteration's wgmma group is done.
//
// Float32 with co < 8 (the RGB head, and ODIN's input gradient at conv_0)
// takes head_conv_kernel on the CUDA cores: the exact channels (no
// padding to a tensor-core tile), 8 output columns a thread, each staged
// x loaded once per tap row and used by every tap of that row, the tap
// row's weights in registers, a fresh partial sum per chunk of 4
// channels.  Its bound is the CUDA cores' 67 TFLOP/s.  Dispatch is by
// shape only (ops/same_grid_conv.py::kernel_route mirrors it, and
// tests/test_torch_conv_layout.py emulates the wgmma K order and
// arithmetic).

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SMEM = 227 * 1024;

template <typename T> __host__ __device__ constexpr int epu() {
  return 16 / (int)sizeof(T);            // elements in 16 bytes
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;               // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = big + small to ~21 bits: big is v rounded to TF32 (half a TF32 ulp
// added, the 13 low bits cleared), small = v - big is exact in float32 and
// is cut to TF32.
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator registers across the
// asynchronous wgmma
template <int N> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors of B: K-major, no swizzle.  A core
// matrix is 8 rows (n) of 16 bytes (k), 128 bytes contiguous; a unit's
// four core matrices along K are adjacent (LBO), and the 8-row groups
// along N follow each other (SBO).
constexpr int CORE = 128;
constexpr int LBO = CORE;
constexpr int SBO = 4 * CORE;

__device__ __forceinline__ uint64_t desc_of(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

// wgmma.mma_async with A from registers (the m16n8k8 / m16n8k16 fragment
// layout per warp, warp w of the warpgroup on rows 16w..16w+15) and B by
// descriptor (TF32: K-major; bf16: N-major, imm-trans-b 1); scale_d 0
// starts a fresh sum.
template <typename T, int N> __device__ __forceinline__ void wgmma_rs(
    float* d, const uint32_t* a, uint64_t desc, int scale_d);
template <> __device__ __forceinline__ void wgmma_rs<float, 8>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<float, 16>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<float, 32>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<float, 64>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<float, 128>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 8>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 16>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 32>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}
template <> __device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 128>(
    float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

struct Geom {
  int n, h, w, ci, co, th, tw, ph_lo, pw_lo;
  int rows;         // output rows per block (rows of the flattened n*h grid)
  int tile_w;       // output columns per block
  int col_tiles;    // column tiles per row band
  int br, bw;       // staged band: rows and columns, halo included
  int fold;         // taps folded into K: one 16-byte unit of channels a tap
  int pitch;        // staged pixel, bytes: 64 (one chunk), 16 when folded
  int nchunks;      // channel chunks of 64 bytes (1 when folded)
  int units;        // K units per chunk: taps, or taps / 4 when folded
  int iters;        // iterations per chunk: units / U
  int taps_pad;     // tap table entries: units (x 4 when folded)
  int band_bytes;   // one band slot
  int vec_x;        // 16-byte cp.async copies of x (else element copies)
  int vec_w;        // bf16: 16-byte cp.async copies of w rows (8 co)
};

constexpr int PD = 3;        // weights prefetched PD iterations ahead

// BN output channels, U K units per iteration, WG warpgroups of 64 rows
// each.
template <typename T, int BN, int U, int WG>
struct Tile {
  static constexpr int THREADS = 128 * WG, BM = 64 * WG;
  static constexpr int EPU = epu<T>(), KU = 4 * EPU;   // K per unit
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int TILE = BN / 8 * SBO;            // one unit's B, bytes
  // float32: B in 2 slots of big and small tiles, fed from PD slots of raw
  // rows; bf16: B in PD + 1 slots, copied straight from the weights
  static constexpr int NB = F32 ? 2 : PD + 1;
  static constexpr int SLOT = U * TILE * (F32 ? 2 : 1);
  // 16-byte rows of a slot a thread copies: float32 one (n, kq) row of 4 k
  // (4-byte copies, raw), bf16 one (k, 8 n) row (a 16-byte copy)
  static constexpr int ROWS_B = F32 ? U * 4 * BN : U * KU * BN / 8;
  static constexpr int ITEMS = (ROWS_B + THREADS - 1) / THREADS;
  static constexpr int RAW = F32 ? ROWS_B * 16 : 0;    // one raw slot
  static constexpr int MINB = BN <= 32 && WG == 2 ? 2 : 1;   // blocks an SM
  static_assert(BN % 8 == 0 && BN >= 8 && BN <= 256, "N tile");
};

// The staged position of a unit's channel q (0..KU-1) in the wgmma K order
// is its 16-byte row `kq` of core matrices and element `i` in that row
// (float32: K-major rows of 4 k; bf16: the weights' own rows, 8 n of one
// k, read transposed by wgmma).  A thread holding bytes [16t, 16t+16) of
// a staged pixel holds channels 4t..4t+3 (float32) or 8t..8t+7 (bf16):
// exactly its A fragment of the unit's two K steps.
template <typename T> __device__ __forceinline__ int channel_of(int kq, int i) {
  return sizeof(T) == 4 ? 4 * i + kq : 8 * (i >> 1) + 2 * kq + (i & 1);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(n) : "memory");
}
template <typename T, int BN, int U, int WG>
__global__ void __launch_bounds__(128 * WG, (Tile<T, BN, U, WG>::MINB))
tc_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
               T* __restrict__ y, const Geom g) {
  using S = Tile<T, BN, U, WG>;
  constexpr int EPU = S::EPU, KU = S::KU;
  constexpr bool F32 = S::F32;
  constexpr int NA = BN / 2;                 // accumulator registers
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const bslots = smem;                       // NB x SLOT
  unsigned char* const raw = bslots + S::NB * S::SLOT;      // PD x RAW
  unsigned char* const bands = raw + PD * S::RAW;           // 2 x band
  unsigned char* const zero = bands + 2 * g.band_bytes;     // 64 zero bytes
  int2* const ttab = reinterpret_cast<int2*>(zero + 64);    // tap table

  const int taps = g.th * g.tw;
  const long long total_rows = (long long)g.n * g.h;
  const long long g0 = (long long)(blockIdx.x / g.col_tiles) * g.rows;
  const int c0 = (blockIdx.x % g.col_tiles) * g.tile_w;
  const int co0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  // the two fragment rows of this thread: staged offset of the pixel at
  // tap (0, 0), and a bit per tap row that stays inside the pixel's image
  int aoff[2];
  unsigned rmask[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = (tid >> 5) * 16 + gq + 8 * hh;
    int r = p / g.tile_w, c = p % g.tile_w;
    unsigned m = 0;
    if (r < g.rows && g0 + r < total_rows && c0 + c < g.w) {
      const int yrow = (int)((g0 + r) % g.h);
      for (int a = 0; a < g.th; ++a) {
        const int yy = yrow + a - g.ph_lo;
        if (yy >= 0 && yy < g.h) m |= 1u << a;
      }
    } else {
      r = 0;
      c = 0;
    }
    aoff[hh] = (r * g.bw + c) * g.pitch;
    rmask[hh] = m;
  }
  // bytes of the staged pixel this thread reads: its 16 bytes of the
  // chunk, or (folded) the 16 bytes of its own tap
  const int lane_off = g.fold ? 0 : 16 * tq;
  if (tid < 4) reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);
  // tap j: its shift in the band (bytes) and its row; row -1 past the taps
  for (int j = tid; j < g.taps_pad; j += S::THREADS) {
    const int a = j / g.tw, b = j - a * g.tw;
    ttab[j] = j < taps ? make_int2((a * g.bw + b) * g.pitch, a)
                       : make_int2(0, -1);
  }

  // stage the band of channel chunk `chunk` in band slot `slot`
  auto stage_band = [&](int chunk, int slot) {
    unsigned char* band = bands + slot * g.band_bytes;
    const int vpp = g.pitch / 16;            // 16-byte vectors a pixel
    const int nv = g.br * g.bw * vpp;
    for (int i = tid; i < nv; i += S::THREADS) {
      const int v = i % vpp, pix = i / vpp;
      const int row = pix / g.bw, col = pix % g.bw;
      const long long gr = g0 - g.ph_lo + row;
      const int gc = c0 - g.pw_lo + col, cin = chunk * KU + v * EPU;
      const bool in = gr >= 0 && gr < total_rows && gc >= 0 && gc < g.w;
      T* dst = reinterpret_cast<T*>(band + pix * g.pitch + v * 16);
      if (g.vec_x) {
        const bool ok = in && cin < g.ci;
        cp_async16(dst, ok ? x + (gr * g.w + gc) * g.ci + cin : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < EPU; ++e)
          dst[e] = in && cin + e < g.ci ? x[(gr * g.w + gc) * g.ci + cin + e]
                                        : zero_of<T>();
      }
    }
  };

  // the weights of iteration `it` (U units) as cp.async copies: float32
  // into the raw slot (each thread its own rows, four 4-byte copies of
  // its (n, kq) row), bf16 straight into B slot it % NB (16 bytes: 8 co
  // of one channel, or element stores where co is not a multiple of 8)
  auto copy_b = [&](int it) {
    const int chunk = it / g.iters, u0 = (it % g.iters) * U;
#pragma unroll
    for (int m = 0; m < S::ITEMS; ++m) {
      const int item = tid + m * S::THREADS;
      if (item >= S::ROWS_B) break;
      if constexpr (F32) {
        const int n = item % BN, kq = (item / BN) % 4;
        const int unit = u0 + item / (4 * BN);
        unsigned char* dst = raw + (it % PD) * S::RAW + item * 16;
        const bool okn = unit < g.units && co0 + n < g.co;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = channel_of<T>(kq, i);
          const int tap = g.fold ? unit * 4 + q / EPU : unit;
          const int cin = g.fold ? q % EPU : chunk * KU + q;
          const bool ok = okn && tap < taps && cin < g.ci;
          cp_async4(dst + 4 * i,
                    ok ? wt + ((long long)tap * g.ci + cin) * g.co + co0 + n
                       : wt, ok);
        }
      } else {
        const int ng = item % (BN / 8), k = (item / (BN / 8)) % KU;
        const int unit = u0 + item / (KU * BN / 8);
        const int q = channel_of<T>(k / EPU, k % EPU);
        const int tap = g.fold ? unit * 4 + q / EPU : unit;
        const int cin = g.fold ? q % EPU : chunk * KU + q;
        const int n0 = co0 + 8 * ng;
        const bool ok = unit < g.units && tap < taps && cin < g.ci;
        unsigned char* dst = bslots + (it % S::NB) * S::SLOT +
                             (item / (KU * BN / 8)) * S::TILE +
                             ng * SBO + (k / EPU) * CORE + (k % EPU) * 16;
        const T* src = wt + ((long long)tap * g.ci + cin) * g.co + n0;
        if (g.vec_w) {
          cp_async16(dst, ok && n0 < g.co ? src : wt, ok && n0 < g.co);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            reinterpret_cast<T*>(dst)[e] =
                ok && n0 + e < g.co ? src[e] : zero_of<T>();
        }
      }
    }
  };
  // float32: this thread's raw rows of iteration `it` split into big and
  // small K-major rows of B slot it % 2
  auto split_b = [&](int it) {
    unsigned char* base = bslots + (it & 1) * S::SLOT;
#pragma unroll
    for (int m = 0; m < S::ITEMS; ++m) {
      const int item = tid + m * S::THREADS;
      if (item >= S::ROWS_B) break;
      const int n = item % BN, kq = (item / BN) % 4, u = item / (4 * BN);
      const float4 v = *reinterpret_cast<const float4*>(
          raw + (it % PD) * S::RAW + item * 16);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      uint32_t bg[4], sm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(vv[i], bg[i], sm[i]);
      const int off = (n >> 3) * SBO + kq * CORE + (n & 7) * 16;
      *reinterpret_cast<uint4*>(base + 2 * u * S::TILE + off) =
          make_uint4(bg[0], bg[1], bg[2], bg[3]);
      *reinterpret_cast<uint4*>(base + (2 * u + 1) * S::TILE + off) =
          make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
  };

  float acc[NA], part[F32 ? NA : 1];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (F32 ? NA : 1); ++i) part[i] = 0.f;

  // one cp.async group an iteration: group j holds the weights of
  // iteration j (and the band of chunk 0, or of the next chunk)
  const int iters = g.nchunks * g.iters;
  stage_band(0, 0);
#pragma unroll
  for (int j = 0; j < PD; ++j) {
    if (j < iters) copy_b(j);
    cp_async_commit();
  }
  if constexpr (F32) {
    cp_async_wait<PD - 1>();
    split_b(0);
  }

  for (int it = 0; it < iters; ++it) {
    const int chunk = it / g.iters, u0 = (it % g.iters) * U;
    if (u0 == 0 && it > 0)
      cp_async_wait<0>();                    // this chunk's band
    else if constexpr (!F32)
      cp_async_wait<PD - 1>();               // this iteration's weights
    fence_proxy_async();                     // B stores and copies
    __syncthreads();
    // the next chunk's band into the other slot, read last by the
    // previous chunk's fragment loads (all before the barrier)
    if (u0 == 0 && chunk + 1 < g.nchunks)
      stage_band(chunk + 1, (chunk + 1) & 1);
    // the weights PD iterations on; their slot was read last by the
    // previous iteration's group, which every warpgroup waited for
    if (it + PD < iters) copy_b(it + PD);
    cp_async_commit();
    const unsigned char* band = bands + (chunk & 1) * g.band_bytes;
    const int nu = min(U, g.units - u0);

    // A fragments of the iteration's units: per row one 16-byte load, the
    // tap's shifted pixel or the zero row
    uint32_t fa[U][2][4], fs[U][2][4];       // big (or bf16) and small
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) break;
      const int2 t = ttab[g.fold ? (u0 + u) * 4 + tq : u0 + u];
      uint4 v[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bool sel = t.y >= 0 && ((rmask[hh] >> t.y) & 1u);
        const unsigned char* p =
            sel ? band + aoff[hh] + t.x + lane_off : zero + lane_off;
        v[hh] = *reinterpret_cast<const uint4*>(p);
      }
      const uint32_t w0[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
      const uint32_t w1[4] = {v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t f[4] = {w0[2 * s], w1[2 * s], w0[2 * s + 1],
                               w1[2 * s + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (F32)
            split(__uint_as_float(f[e]), fa[u][s][e], fs[u][s][e]);
          else
            fa[u][s][e] = f[e];
        }
      }
    }

    wgmma_fence();
    const uint32_t slot = (uint32_t)__cvta_generic_to_shared(
        bslots + (it % S::NB) * S::SLOT);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) break;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if constexpr (F32) {
          const uint32_t tb = slot + 2 * u * S::TILE + s * 2 * CORE;
          const uint64_t db = desc_of(tb), ds = desc_of(tb + S::TILE);
          // the correction terms first, then big*big
          wgmma_rs<float, BN>(part, fs[u][s], db, u > 0 || s > 0);
          wgmma_rs<float, BN>(part, fa[u][s], ds, 1);
          wgmma_rs<float, BN>(part, fa[u][s], db, 1);
        } else {
          wgmma_rs<__nv_bfloat16, BN>(
              acc, fa[u][s], desc_of(slot + u * S::TILE + s * 2 * CORE), 1);
        }
      }
    }
    wgmma_commit();
    // float32: the next iteration's raw rows, landed (group it + 1), split
    // into the other B slot while the group runs; its last reader, the
    // previous group, is done
    if constexpr (F32) {
      if (it + 1 < iters) {
        cp_async_wait<PD - 1>();
        split_b(it + 1);
      }
    }
    wgmma_wait_all();
    if constexpr (F32) {
      fence_regs<NA>(part);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += part[i];
    } else {
      fence_regs<NA>(acc);
    }
  }

  // D fragment: per 8 columns j, rows gq and gq+8 at columns 2tq, 2tq+1
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = (tid >> 5) * 16 + gq + 8 * hh;
    const int r = p / g.tile_w, c = p % g.tile_w;
    if (!(r < g.rows && g0 + r < total_rows && c0 + c < g.w)) continue;
    T* yp = y + ((g0 + r) * g.w + c0 + c) * g.co;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = co0 + 8 * j + 2 * tq;
      if (col < g.co) store_f32(yp + col, acc[4 * j + 2 * hh]);
      if (col + 1 < g.co) store_f32(yp + col + 1, acc[4 * j + 2 * hh + 1]);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int BN, int U, int WG>
cudaError_t launch_tc(const T* x, const T* w, T* y, Geom g,
                      cudaStream_t stream) {
  using S = Tile<T, BN, U, WG>;
  constexpr int EPU = S::EPU;
  g.tile_w = g.w < S::BM ? g.w : S::BM;
  g.rows = S::BM / g.tile_w;
  g.col_tiles = (g.w + g.tile_w - 1) / g.tile_w;
  g.br = g.rows + g.th - 1;
  g.bw = g.tile_w + g.tw - 1;
  g.fold = g.ci <= EPU;
  g.pitch = g.fold ? 16 : 64;
  g.nchunks = g.fold ? 1 : (g.ci + S::KU - 1) / S::KU;
  g.units = g.fold ? (g.th * g.tw + 3) / 4 : g.th * g.tw;
  g.iters = (g.units + U - 1) / U;
  g.taps_pad = g.fold ? 4 * g.units : g.units;
  g.band_bytes = (g.br * g.bw * g.pitch + 127) / 128 * 128;
  g.vec_x = (g.fold ? g.ci == EPU : g.ci % EPU == 0) && aligned16(x);
  g.vec_w = g.co % 8 == 0 && aligned16(w);
  const size_t smem = (size_t)S::NB * S::SLOT + (size_t)PD * S::RAW +
                      2 * (size_t)g.band_bytes + 64 + 8 * (size_t)g.taps_pad;
  const long long bands = ((long long)g.n * g.h + g.rows - 1) / g.rows;
  const long long gx = bands * g.col_tiles;
  const long long gy = (g.co + BN - 1) / BN;
  if (gx <= 0 || gx > INT_MAX || gy > 65535 || smem > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = tc_conv_kernel<T, BN, U, WG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((unsigned)gx, (unsigned)gy), S::THREADS, smem, stream>>>(x, w, y,
                                                                      g);
  return cudaGetLastError();
}

// ---- mma.sync kernel (the tensor-core kernel before wgmma): kept for the
// shapes where one call on the card times it faster than the wgmma kernel
// (see dispatch): the non-folded co <= 32 sites.  M a band of BM output
// pixels, N a tile of BN channels, K chunks of 32 bytes of channels with
// every tap's weights staged per chunk in a two-slot cp.async ring; A
// fragments read from the staged band per tap (a zero row where the tap
// leaves the image), 3xTF32 or one bf16 pass on mma.sync m16n8k8 /
// m16n8k16, a fresh partial sum per chunk.

constexpr int MMA_THREADS = 256;             // 8 warps

#define HD __host__ __device__
template <typename T> HD constexpr int chunk() { return 32 / (int)sizeof(T); }
// staged pixel pitch in elements: 32 bytes of channels and 16 of padding,
// which keeps the fragment reads free of bank conflicts
template <typename T> HD constexpr int kcp() { return 48 / (int)sizeof(T); }
// staged weight row pitch in elements: conflict-free B fragment reads
// (float32: 4-byte words; bf16: ldmatrix rows of 16 bytes)
template <typename T> HD constexpr int bnp(int bn) {
  return sizeof(T) == 4 ? (bn == 8 ? 8 : bn + 8) : (bn == 8 ? 24 : bn + 8);
}


__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// B fragment of m16n8k16 from a row-major [k][n] tile: rows k0..k0+15
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

struct MGeom {
  int n, h, w, ci, co, th, tw, ph_lo, pw_lo;
  int rows;         // output rows per block (rows of the flattened n*h grid)
  int tile_w;       // output columns per block
  int col_tiles;    // column tiles per row band
  int br, bw;       // staged band: rows and columns, halo included
  int band_elems;   // staged band and a zero row of tw pixels, elements
  int stage_elems;  // band + every tap's weights for one channel chunk
  int vec_x, vec_w; // 16-byte cp.async copies (else element copies)
};

// Fill the band tiling for a BM-pixel, BN-channel tile; returns shared bytes.
template <typename T, int BM, int BN>
size_t mma_layout(MGeom& g) {
  g.tile_w = g.w < BM ? g.w : BM;
  g.rows = BM / g.tile_w;
  g.col_tiles = (g.w + g.tile_w - 1) / g.tile_w;
  g.br = g.rows + g.th - 1;
  g.bw = g.tile_w + g.tw - 1;
  g.band_elems = (g.br * g.bw + g.tw) * kcp<T>();
  g.stage_elems = g.band_elems + g.th * g.tw * chunk<T>() * bnp<T>(BN);
  return 2 * (size_t)g.stage_elems * sizeof(T);        // two ring slots
}

// BM output pixels x BN output channels a block; WARPS_N warps along the
// channels, the rest along the pixels.
template <typename T, int BM, int BN, int WARPS_N>
__global__ void __launch_bounds__(MMA_THREADS, 2)
mma_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
               T* __restrict__ y, const MGeom g) {
  constexpr int KC = chunk<T>(), KCP = kcp<T>(), VEC = epu<T>();
  constexpr int BNP = bnp<T>(BN);
  constexpr int WARPS_M = MMA_THREADS / 32 / WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && MT >= 1 && NT >= 1, "tile");
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int taps = g.th * g.tw;
  const long long total_rows = (long long)g.n * g.h;
  const long long g0 = (long long)(blockIdx.x / g.col_tiles) * g.rows;
  const int c0 = (blockIdx.x % g.col_tiles) * g.tile_w;
  const int co0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int gq = lane >> 2, tq = lane & 3;

  // the fragment rows this thread holds: band offset of the pixel at tap
  // (0, 0), and a bit per tap row that stays inside the pixel's image
  int aoff[MT][2];
  unsigned rmask[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = wm0 + mt * 16 + gq + 8 * hh;
      int r = p / g.tile_w, c = p % g.tile_w;
      unsigned m = 0;
      if (r < g.rows && g0 + r < total_rows && c0 + c < g.w) {
        const int yrow = (int)((g0 + r) % g.h);
        for (int a = 0; a < g.th; ++a) {
          const int yy = yrow + a - g.ph_lo;
          if (yy >= 0 && yy < g.h) m |= 1u << a;
        }
      } else {
        r = 0;
        c = 0;
      }
      aoff[mt][hh] = (r * g.bw + c) * KCP;
      rmask[mt][hh] = m;
    }

  // The tensor cores add each product sum into the accumulator with its
  // low bits truncated, an error of up to an ulp of the accumulator per
  // mma.  A chunk's products therefore go into a fresh partial sum, which
  // is added to the total (round to nearest) once the chunk is done.
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = part[mt][nt][j] = 0.f;

  // stage channel chunk `kc` (input band + every tap's weights) in `slot`
  auto stage = [&](int kc, int slot) {
    T* band = smem + slot * g.stage_elems;
    T* ws = band + g.band_elems;
    const int ci0 = kc * KC;
    if (g.vec_x) {
      const int nv = g.br * g.bw * (KC / VEC);
      for (int i = tid; i < nv; i += MMA_THREADS) {
        const int v = i % (KC / VEC), pix = i / (KC / VEC);
        const int row = pix / g.bw, col = pix % g.bw;
        const long long gr = g0 - g.ph_lo + row;
        const int gc = c0 - g.pw_lo + col, cin = ci0 + v * VEC;
        const bool ok = gr >= 0 && gr < total_rows && gc >= 0 && gc < g.w &&
                        cin < g.ci;
        cp_async16(band + pix * KCP + v * VEC,
                   ok ? x + (gr * g.w + gc) * g.ci + cin : x, ok);
      }
    } else {
      for (int i = tid; i < g.br * g.bw * KC; i += MMA_THREADS) {
        const int c = i % KC, pix = i / KC;
        const int row = pix / g.bw, col = pix % g.bw;
        const long long gr = g0 - g.ph_lo + row;
        const int gc = c0 - g.pw_lo + col, cin = ci0 + c;
        T v = zero_of<T>();
        if (gr >= 0 && gr < total_rows && gc >= 0 && gc < g.w && cin < g.ci)
          v = x[(gr * g.w + gc) * g.ci + cin];
        band[pix * KCP + c] = v;
      }
    }
    if (g.vec_w) {
      constexpr int NV = BN / VEC;
      for (int i = tid; i < taps * KC * NV; i += MMA_THREADS) {
        const int v = i % NV, r = i / NV;
        const int k = r % KC, tap = r / KC;
        const int cin = ci0 + k, cout = co0 + v * VEC;
        const bool ok = cin < g.ci && cout < g.co;
        cp_async16(ws + (tap * KC + k) * BNP + v * VEC,
                   ok ? wt + ((long long)tap * g.ci + cin) * g.co + cout : wt,
                   ok);
      }
    } else {
      for (int i = tid; i < taps * KC * BN; i += MMA_THREADS) {
        const int o = i % BN, r = i / BN;
        const int k = r % KC, tap = r / KC;
        const int cin = ci0 + k, cout = co0 + o;
        T v = zero_of<T>();
        if (cin < g.ci && cout < g.co)
          v = wt[((long long)tap * g.ci + cin) * g.co + cout];
        ws[(tap * KC + k) * BNP + o] = v;
      }
    }
  };

  // after each slot's band, a zero row of tw pixels: masked fragment rows
  // read it instead of a neighbouring image's row
  const int zero_rel = g.br * g.bw * KCP;
  for (int i = tid; i < g.tw * KCP; i += MMA_THREADS) {
    smem[zero_rel + i] = zero_of<T>();
    smem[g.stage_elems + zero_rel + i] = zero_of<T>();
  }

  const int nchunks = (g.ci + KC - 1) / KC;
  stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) stage(kc + 1, (kc + 1) & 1);
    cp_async_commit();               // an empty group on the last chunk
    cp_async_wait<1>();                // chunk kc has landed
    __syncthreads();
    const int band0 = (kc & 1) * g.stage_elems;
    const T* ws = smem + band0 + g.band_elems;
    for (int a = 0; a < g.th; ++a) {
      // each fragment row's staged pixel for tap (a, 0), or the zero row
      // where tap row a leaves the pixel's image
      int roff[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          roff[mt][hh] = band0 + ((rmask[mt][hh] >> a) & 1u
                                      ? a * g.bw * KCP + aoff[mt][hh]
                                      : zero_rel);
      for (int b = 0; b < g.tw; ++b) {
        const T* wtap = ws + (a * g.tw + b) * KC * BNP + wn0;
        if constexpr (F32) {
          uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            split(wtap[tq * BNP + nt * 8 + gq], bb[nt][0], bs[nt][0]);
            split(wtap[(tq + 4) * BNP + nt * 8 + gq], bb[nt][1], bs[nt][1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // A: rows gq, gq+8 at channels tq, tq+4
            const float* r0 = smem + roff[mt][0] + b * KCP;
            const float* r1 = smem + roff[mt][1] + b * KCP;
            const float v[4] = {r0[tq], r1[tq], r0[tq + 4], r1[tq + 4]};
            uint32_t ab[4], as[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) split(v[j], ab[j], as[j]);
            // the correction terms first, then big*big
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_tf32(part[mt][nt], as, bb[nt]);
              mma_tf32(part[mt][nt], ab, bs[nt]);
              mma_tf32(part[mt][nt], ab, bb[nt]);
            }
          }
        } else {
          uint32_t bf[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            ldsm_x2_trans(bf[nt], wtap + (lane & 15) * BNP + nt * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // A: rows gq, gq+8 at 32-bit words tq, tq+4 of the pixel
            const uint32_t* r0 = reinterpret_cast<const uint32_t*>(
                smem + roff[mt][0] + b * KCP);
            const uint32_t* r1 = reinterpret_cast<const uint32_t*>(
                smem + roff[mt][1] + b * KCP);
            const uint32_t af[4] = {r0[tq], r1[tq], r0[tq + 4], r1[tq + 4]};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(part[mt][nt], af, bf[nt]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[mt][nt][j] += part[mt][nt][j];
          part[mt][nt][j] = 0.f;
        }
    __syncthreads();                 // the slot is free for chunk kc + 2
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = wm0 + mt * 16 + gq + 8 * hh;
      const int r = p / g.tile_w, c = p % g.tile_w;
      if (!(r < g.rows && g0 + r < total_rows && c0 + c < g.w)) continue;
      T* yp = y + ((g0 + r) * g.w + c0 + c) * g.co;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cout = co0 + wn0 + nt * 8 + 2 * tq;
        if (cout < g.co) store_f32(yp + cout, acc[mt][nt][2 * hh]);
        if (cout + 1 < g.co) store_f32(yp + cout + 1, acc[mt][nt][2 * hh + 1]);
      }
    }
}

template <typename T, int BM, int BN, int WARPS_N>
cudaError_t launch_mma(const T* x, const T* w, T* y, MGeom g,
                      cudaStream_t stream) {
  const size_t smem = mma_layout<T, BM, BN>(g);
  const long long bands = ((long long)g.n * g.h + g.rows - 1) / g.rows;
  const long long gx = bands * g.col_tiles;
  const long long gy = (g.co + BN - 1) / BN;
  if (gx <= 0 || gx > INT_MAX || gy > 65535 || smem > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = mma_conv_kernel<T, BM, BN, WARPS_N>;
  // all of the SM's unified memory as shared memory, so that two blocks fit
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((unsigned)gx, (unsigned)gy), MMA_THREADS, smem, stream>>>(x, w, y,
                                                                    g);
  return cudaGetLastError();
}

// ---- float32 with co < 8 on the CUDA cores

constexpr int PX = 8;         // output columns a thread
constexpr int HC = 4;         // input channels a staged chunk (16 bytes)

struct HGeom {
  int n, h, w, ci, co, th, tw, ph_lo, pw_lo;
  int tile_w;       // output columns per block, a multiple of PX, <= 32
  int ncg;          // column groups of PX (tile_w / PX)
  int rows;         // output rows per block (threads / ncg)
  int col_tiles;
  int br, bwp;      // staged band rows, and columns (odd: conflict-free)
  int band_floats, w_floats;
  int vec_x;
};

// Thread (cg, lr): output row lr of the band, columns cg*PX .. +PX-1, all
// CO channels.  Neighbouring lanes take neighbouring rows, so a warp's
// 16-byte loads hit distinct banks (odd staged width).  TW = 0 takes tw
// at run time, loading x per tap.
template <int CO, int TW>
__global__ void __launch_bounds__(256)
head_conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                 float* __restrict__ y, const HGeom g) {
  extern __shared__ __align__(16) float hsm[];
  const int slot_floats = g.band_floats + g.w_floats;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int cg = tid / g.rows, lr = tid % g.rows, lc0 = cg * PX;
  const int taps = g.th * g.tw;
  const long long total_rows = (long long)g.n * g.h;
  const long long g0 = (long long)(blockIdx.x / g.col_tiles) * g.rows;
  const int c0 = (blockIdx.x % g.col_tiles) * g.tile_w;
  const bool row_ok = cg < g.ncg && g0 + lr < total_rows;
  unsigned rmask = 0;
  if (row_ok) {
    const int yrow = (int)((g0 + lr) % g.h);
    for (int a = 0; a < g.th; ++a) {
      const int yy = yrow + a - g.ph_lo;
      if (yy >= 0 && yy < g.h) rmask |= 1u << a;
    }
  }

  auto stage = [&](int chunk, int slot) {
    float* band = hsm + slot * slot_floats;
    float* ws = band + g.band_floats;
    const int cin = chunk * HC;
    for (int i = tid; i < g.br * g.bwp; i += nthreads) {
      const int row = i / g.bwp, col = i % g.bwp;
      const long long gr = g0 - g.ph_lo + row;
      const int gc = c0 - g.pw_lo + col;
      const bool in = gr >= 0 && gr < total_rows && gc >= 0 && gc < g.w;
      if (g.vec_x) {
        const bool ok = in && cin < g.ci;
        cp_async16(band + 4 * i, ok ? x + (gr * g.w + gc) * g.ci + cin : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < HC; ++e)
          band[4 * i + e] = in && cin + e < g.ci
                                ? x[(gr * g.w + gc) * g.ci + cin + e] : 0.f;
      }
    }
    for (int i = tid; i < taps * HC * CO; i += nthreads) {
      const int o = i % CO, r = i / CO, cc = r % HC, tap = r / HC;
      ws[i] = cin + cc < g.ci
                  ? wt[((long long)tap * g.ci + cin + cc) * CO + o] : 0.f;
    }
  };

  float acc[PX][CO];
#pragma unroll
  for (int px = 0; px < PX; ++px)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[px][o] = 0.f;

  const int nch = (g.ci + HC - 1) / HC;
  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < nch) {                 // the slot read by chunk c - 1
      stage(c + 1, (c + 1) & 1);
      cp_async_commit();
    }
    const float4* band =
        reinterpret_cast<const float4*>(hsm + (c & 1) * slot_floats);
    const float* ws = hsm + (c & 1) * slot_floats + g.band_floats;
    // the chunk's products into a fresh partial sum, added to the total
    // once the chunk is done: a float32 sum of ci*taps products in one
    // chain drifts past 1e-5 at ci = 100, 5x5
    float part[PX][CO];
#pragma unroll
    for (int px = 0; px < PX; ++px)
#pragma unroll
      for (int o = 0; o < CO; ++o) part[px][o] = 0.f;
    for (int a = 0; a < g.th; ++a) {
      if (!((rmask >> a) & 1u)) continue;
      const float4* xr = band + (lr + a) * g.bwp + lc0;
      const float* wa = ws + a * g.tw * HC * CO;
      if constexpr (TW > 0) {
        float wr[TW][HC][CO];
#pragma unroll
        for (int b = 0; b < TW; ++b)
#pragma unroll
          for (int cc = 0; cc < HC; ++cc)
#pragma unroll
            for (int o = 0; o < CO; ++o)
              wr[b][cc][o] = wa[(b * HC + cc) * CO + o];
#pragma unroll
        for (int xi = 0; xi < PX + TW - 1; ++xi) {
          const float4 q = xr[xi];
          const float xv[HC] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int b = 0; b < TW; ++b) {
            const int px = xi - b;
            if (px < 0 || px >= PX) continue;
#pragma unroll
            for (int cc = 0; cc < HC; ++cc)
#pragma unroll
              for (int o = 0; o < CO; ++o)
                part[px][o] = fmaf(xv[cc], wr[b][cc][o], part[px][o]);
          }
        }
      } else {
        for (int b = 0; b < g.tw; ++b) {
          float wr[HC][CO];
#pragma unroll
          for (int cc = 0; cc < HC; ++cc)
#pragma unroll
            for (int o = 0; o < CO; ++o) wr[cc][o] = wa[(b * HC + cc) * CO + o];
#pragma unroll
          for (int px = 0; px < PX; ++px) {
            const float4 q = xr[px + b];
            const float xv[HC] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int cc = 0; cc < HC; ++cc)
#pragma unroll
              for (int o = 0; o < CO; ++o)
                part[px][o] = fmaf(xv[cc], wr[cc][o], part[px][o]);
          }
        }
      }
    }
#pragma unroll
    for (int px = 0; px < PX; ++px)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[px][o] += part[px][o];
  }

  if (!row_ok) return;
#pragma unroll
  for (int px = 0; px < PX; ++px) {
    const int col = c0 + lc0 + px;
    if (lc0 + px >= g.tile_w || col >= g.w) continue;
    float* yp = y + ((g0 + lr) * g.w + col) * CO;
#pragma unroll
    for (int o = 0; o < CO; ++o) yp[o] = acc[px][o];
  }
}

template <int CO, int TW>
cudaError_t launch_head(const float* x, const float* w, float* y, HGeom g,
                        int threads, cudaStream_t stream) {
  g.rows = threads / g.ncg;
  g.br = g.rows + g.th - 1;
  const long long bands = ((long long)g.n * g.h + g.rows - 1) / g.rows;
  const long long gx = bands * g.col_tiles;
  g.band_floats = g.br * g.bwp * HC;
  const size_t smem =
      2 * sizeof(float) * ((size_t)g.band_floats + (size_t)g.w_floats);
  if (gx <= 0 || gx > INT_MAX || smem > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = head_conv_kernel<CO, TW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)gx, threads, smem, stream>>>(x, w, y, g);
  return cudaGetLastError();
}

template <int CO>
cudaError_t head_tw(const float* x, const float* w, float* y, HGeom g,
                    int threads, cudaStream_t s) {
  if (g.tw == 5) return launch_head<CO, 5>(x, w, y, g, threads, s);   // 5x5
  return launch_head<CO, 0>(x, w, y, g, threads, s);
}

cudaError_t launch_head_conv(const float* x, const float* w, float* y,
                             const HGeom& g0, cudaStream_t s) {
  HGeom g = g0;
  const int w8 = (g.w + PX - 1) / PX * PX;
  g.tile_w = w8 < 32 ? w8 : 32;
  g.ncg = g.tile_w / PX;
  g.col_tiles = (g.w + g.tile_w - 1) / g.tile_w;
  g.bwp = (g.tile_w + g.tw - 1) | 1;
  g.w_floats = (g.th * g.tw * HC * g.co + 3) / 4 * 4;
  g.vec_x = g.ci % HC == 0 && aligned16(x);
  // blocks of 256 threads, or of 64 where that leaves the card's 132 SMs
  // less than two blocks each
  const long long rows256 = 256 / g.ncg;
  const long long blocks256 =
      ((long long)g.n * g.h + rows256 - 1) / rows256 * g.col_tiles;
  const int threads = blocks256 < 2 * 132 ? 64 : 256;
  switch (g.co) {
    case 1: return head_tw<1>(x, w, y, g, threads, s);
    case 2: return head_tw<2>(x, w, y, g, threads, s);
    case 3: return head_tw<3>(x, w, y, g, threads, s);
    case 4: return head_tw<4>(x, w, y, g, threads, s);
    case 5: return head_tw<5>(x, w, y, g, threads, s);
    case 6: return head_tw<6>(x, w, y, g, threads, s);
    case 7: return head_tw<7>(x, w, y, g, threads, s);
  }
  return cudaErrorInvalidValue;
}

// By shape only, each choice timed in one call on the card against the
// mma.sync kernel (scripts/time_torch_conv.py, PERF.md): float32 with
// co < 8 on the CUDA cores; ci folded into K (ci of at most 16 bytes) on
// wgmma with two warpgroups; co <= 32 otherwise on mma.sync (N tiles of
// 8 or 32, where an A fragment feeds too few wgmma columns); wider co on
// wgmma with four warpgroups, N = 64 (float32: the registers of N = 128
// leave too few warps) or N = 128 (bf16).
template <typename T>
int dispatch(const void* x, const void* w, void* y, int n, int h, int wd,
             int ci, int co, int th, int tw, int ph_lo, int pw_lo,
             void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (th > 32 || th < 1 || tw < 1 || ci < 1 || co < 1)
    return (int)cudaErrorInvalidValue;
  constexpr bool F32 = std::is_same<T, float>::value;
  if constexpr (F32) {
    if (co < 8) {
      HGeom hg{n, h, wd, ci, co, th, tw, ph_lo, pw_lo};
      return (int)launch_head_conv(xp, wp, yp, hg, s);
    }
  }
  Geom g{n, h, wd, ci, co, th, tw, ph_lo, pw_lo};
  MGeom mg{n, h, wd, ci, co, th, tw, ph_lo, pw_lo};
  mg.vec_x = ci % epu<T>() == 0 && aligned16(x);
  mg.vec_w = co % epu<T>() == 0 && aligned16(w);
  constexpr int U1 = F32 ? 2 : 4;          // K units an iteration
  if (ci * (int)sizeof(T) <= 16) {
    if (co <= 8) return (int)launch_tc<T, 8, U1, 2>(xp, wp, yp, g, s);
    if (co <= 16) return (int)launch_tc<T, 16, U1, 2>(xp, wp, yp, g, s);
    if (co <= 32) return (int)launch_tc<T, 32, U1, 2>(xp, wp, yp, g, s);
  } else if (co <= 32) {
    if (co > 8) return (int)launch_mma<T, 256, 32, 1>(xp, wp, yp, mg, s);
    return (int)launch_mma<T, 128, 8, 1>(xp, wp, yp, mg, s);
  }
  if constexpr (F32) {
    return (int)launch_tc<T, 64, U1, 4>(xp, wp, yp, g, s);
  } else {
    if (co <= 64) return (int)launch_tc<T, 64, U1, 4>(xp, wp, yp, g, s);
    return (int)launch_tc<T, 128, 2, 4>(xp, wp, yp, g, s);
  }
}

}  // namespace

extern "C" {

int same_grid_conv_f32(const void* x, const void* w, void* y, int n, int h,
                       int wd, int ci, int co, int th, int tw, int ph_lo,
                       int pw_lo, void* stream) {
  return dispatch<float>(x, w, y, n, h, wd, ci, co, th, tw, ph_lo, pw_lo,
                         stream);
}

int same_grid_conv_bf16(const void* x, const void* w, void* y, int n, int h,
                        int wd, int ci, int co, int th, int tw, int ph_lo,
                        int pw_lo, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, y, n, h, wd, ci, co, th, tw, ph_lo,
                                 pw_lo, stream);
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
