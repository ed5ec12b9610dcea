// Same-grid NHWC convolution for Hopper (sm_90a) on the tensor cores,
// plain C interface.
//
// Replaces the TPU kernel joint_vae_tpu/ops/pallas_conv.py
// (_same_grid_conv_impl / _kernel_body): a stride-(1,1) conv whose output
// grid equals its input grid, y[n,i,j,o] = sum_{a,b,c} x[n, i+a-ph_lo,
// j+b-pw_lo, c] * w[a,b,c,o] with zeros outside the image, pads
// (ph_lo, th-1-ph_lo) x (pw_lo, tw-1-pw_lo), possibly asymmetric.  No bias.
// x (n,h,w,ci) and w (th,tw,ci,co) are float32 or bfloat16, contiguous;
// y (n,h,w,co) is in the input type; accumulation is float32.  The model
// calls it at its stride-1 (de)convs and, through the sub-pixel lowering,
// at its stride-2 deconvs (3x3 packed taps to 4*co phase-packed channels),
// the TPU kernel's two call sites.
//
// What bounds it on this card: operations.  Each output value costs
// 2*taps*ci FLOPs (150-3,200 at the model's shapes) against a few bytes
// moved.  Float32 runs as 3xTF32 on the tensor cores: each operand v is
// split into big (v rounded to TF32) and small (v - big, cut to TF32), and
// the products small*big + big*small, then big*big, accumulate in float32
// (single-pass TF32 keeps ~3 digits).  That is three TF32 products per
// product, so the bound is 3 * FLOPs / 495 TFLOP/s, against FLOPs / 67
// TFLOP/s on the CUDA cores.  bfloat16 is one pass at 989 TFLOP/s.
//
// What the design does about it: an implicit GEMM.  M is a band of 128
// output pixels, whole rows of the flattened n*h row grid (several 8x8
// images share a block, and no fragment row idles), N a tile of 64 output
// channels (32 for co <= 32; blockIdx.y; co = 256 takes four tiles),
// K runs over chunks of input channels x taps.  Per chunk of 32 bytes of
// channels (8 float32 or 16 bf16) a block stages the band's input rows
// plus the halo and that chunk of every tap's weights with cp.async into
// a two-stage ring, so the next chunk loads while the current one
// computes.  A tap's operand is the staged band shifted by the tap; rows
// that belong to a neighbouring image read a zero row instead (masked per
// tap row, as the TPU kernel masks its flat row shifts), and halo columns
// are zero-filled when staged.  Staged pixels take 48 bytes (32 of
// channels) and weight rows BN+8 elements, so fragment reads are free of
// bank conflicts.  Each chunk's products go into a fresh partial sum that
// is added to the total once the chunk is done (see the kernel).
//
// Instructions: mma.sync (m16n8k8 .tf32, m16n8k16 .bf16), not wgmma.  A
// tap's shifted window is not a canonical wgmma shared-memory tile, so
// wgmma would take A from registers in 64-row warpgroup tiles whose rows
// cross image rows at every tap; mma.sync takes the same per-thread
// fragments in 16-row tiles, and the per-tap mask stays a choice of row
// address.  mma.sync does not reach the card's full tensor-core rate;
// wgmma is the next step for this kernel.  Dispatch is by shape only:
// float32 with co < 8 (the RGB head) takes the CUDA-core kernel below,
// everything else the tensor cores.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;             // 8 warps
constexpr int MAX_SMEM = 227 * 1024;

#define HD __host__ __device__
template <typename T> HD constexpr int chunk() { return 32 / (int)sizeof(T); }
// staged pixel pitch in elements: 32 bytes of channels and 16 of padding,
// which keeps the fragment reads free of bank conflicts
template <typename T> HD constexpr int kcp() { return 48 / (int)sizeof(T); }
template <typename T> HD constexpr int vec() { return 16 / (int)sizeof(T); }
// staged weight row pitch in elements: conflict-free B fragment reads
// (float32: 4-byte words; bf16: ldmatrix rows of 16 bytes)
template <typename T> HD constexpr int bnp(int bn) {
  return sizeof(T) == 4 ? (bn == 8 ? 8 : bn + 8) : (bn == 8 ? 24 : bn + 8);
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
               ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// v = big + small to ~21 bits: big is v rounded to TF32 (half a TF32 ulp
// added, the 13 low bits cleared), small = v - big is exact in float32 and
// is cut to TF32.  Four integer/float ops; cvt.rna.tf32.f32 costs more.
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
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

struct Geom {
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
size_t tc_layout(Geom& g) {
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
__global__ void __launch_bounds__(THREADS, 2)
tc_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
               T* __restrict__ y, const Geom g) {
  constexpr int KC = chunk<T>(), KCP = kcp<T>(), VEC = vec<T>();
  constexpr int BNP = bnp<T>(BN);
  constexpr int WARPS_M = THREADS / 32 / WARPS_N;
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
      for (int i = tid; i < nv; i += THREADS) {
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
      for (int i = tid; i < g.br * g.bw * KC; i += THREADS) {
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
      for (int i = tid; i < taps * KC * NV; i += THREADS) {
        const int v = i % NV, r = i / NV;
        const int k = r % KC, tap = r / KC;
        const int cin = ci0 + k, cout = co0 + v * VEC;
        const bool ok = cin < g.ci && cout < g.co;
        cp_async16(ws + (tap * KC + k) * BNP + v * VEC,
                   ok ? wt + ((long long)tap * g.ci + cin) * g.co + cout : wt,
                   ok);
      }
    } else {
      for (int i = tid; i < taps * KC * BN; i += THREADS) {
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
  for (int i = tid; i < g.tw * KCP; i += THREADS) {
    smem[zero_rel + i] = zero_of<T>();
    smem[g.stage_elems + zero_rel + i] = zero_of<T>();
  }

  const int nchunks = (g.ci + KC - 1) / KC;
  stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) stage(kc + 1, (kc + 1) & 1);
    cp_async_commit();               // an empty group on the last chunk
    cp_async_wait1();                // chunk kc has landed
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
cudaError_t launch_tc(const T* x, const T* w, T* y, Geom g,
                      cudaStream_t stream) {
  const size_t smem = tc_layout<T, BM, BN>(g);
  const long long bands = ((long long)g.n * g.h + g.rows - 1) / g.rows;
  const long long gx = bands * g.col_tiles;
  const long long gy = (g.co + BN - 1) / BN;
  if (gx <= 0 || gx > INT_MAX || gy > 65535 || smem > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = tc_conv_kernel<T, BM, BN, WARPS_N>;
  // all of the SM's unified memory as shared memory, so that two blocks fit
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((unsigned)gx, (unsigned)gy), THREADS, smem, stream>>>(x, w, y,
                                                                    g);
  return cudaGetLastError();
}

// ---- CUDA-core path for float32 with co < 8 (the RGB head): the first
// version of this kernel, 4 channels x 256 pixels a block (TC = 1, CPT = 4,
// PPT = 1).

constexpr int SIMT_CI = 8;        // input channels staged per chunk

// TC thread groups along channels, CPT channels and PPT pixels per thread.
template <int TC, int CPT, int PPT>
__global__ void __launch_bounds__(THREADS)
simt_conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                 float* __restrict__ y, Geom g) {
  constexpr int TP = THREADS / TC;       // threads along pixels
  constexpr int CO_T = TC * CPT;         // output channels per block
  extern __shared__ __align__(16) float smem[];

  const int taps = g.th * g.tw;
  const int hr = g.rows + g.th - 1;      // staged input rows
  const int wsd = g.tile_w + g.tw - 1;   // staged input columns
  const int plane = hr * wsd;
  float* ws = smem;                             // [taps][SIMT_CI][CO_T]
  float* xs = smem + taps * SIMT_CI * CO_T;     // [SIMT_CI][hr][wsd]

  const long long total_rows = (long long)g.n * g.h;
  const long long g0 = (long long)(blockIdx.x / g.col_tiles) * g.rows;
  const int c0 = (blockIdx.x % g.col_tiles) * g.tile_w;
  const int co0 = blockIdx.y * CO_T;

  const int tid = threadIdx.x;
  const int tp = tid % TP;
  const int tc = tid / TP;

  int lr[PPT], lc[PPT], yrow[PPT];
  bool ok[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = tp + TP * i;
    const int r = p / g.tile_w, c = p % g.tile_w;
    ok[i] = r < g.rows && g0 + r < total_rows && c0 + c < g.w;
    lr[i] = ok[i] ? r : 0;
    lc[i] = ok[i] ? c : 0;
    yrow[i] = ok[i] ? (int)((g0 + r) % g.h) : 0;
  }
  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < g.ci; ci0 += SIMT_CI) {
    __syncthreads();
    for (int idx = tid; idx < taps * SIMT_CI * CO_T; idx += THREADS) {
      const int o = idx % CO_T;
      const int r = idx / CO_T;
      const int c = r % SIMT_CI, tap = r / SIMT_CI;
      const int cin = ci0 + c, cout = co0 + o;
      float v = 0.f;
      if (cin < g.ci && cout < g.co)
        v = wt[((long long)tap * g.ci + cin) * g.co + cout];
      ws[idx] = v;
    }
    for (int idx = tid; idx < SIMT_CI * plane; idx += THREADS) {
      const int c = idx % SIMT_CI;
      const int r = idx / SIMT_CI;
      const int col = r % wsd, row = r / wsd;
      const long long gr = g0 - g.ph_lo + row;
      const int gc = c0 - g.pw_lo + col;
      const int cin = ci0 + c;
      float v = 0.f;
      if (gr >= 0 && gr < total_rows && gc >= 0 && gc < g.w && cin < g.ci)
        v = x[(gr * g.w + gc) * g.ci + cin];
      xs[c * plane + row * wsd + col] = v;
    }
    __syncthreads();

    for (int a = 0; a < g.th; ++a) {
      bool rok[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int yy = yrow[i] + a - g.ph_lo;
        rok[i] = ok[i] && yy >= 0 && yy < g.h;
      }
      for (int b = 0; b < g.tw; ++b) {
        const float* wtap = ws + (a * g.tw + b) * SIMT_CI * CO_T + tc * CPT;
        const float* xtap = xs + a * wsd + b;
#pragma unroll
        for (int c = 0; c < SIMT_CI; ++c) {
          float wv[CPT];
          if (CPT == 4) {
            const float4 q = *reinterpret_cast<const float4*>(wtap + c * CO_T);
            wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
          } else {
#pragma unroll
            for (int j = 0; j < CPT; ++j) wv[j] = wtap[c * CO_T + j];
          }
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float xv =
                rok[i] ? xtap[c * plane + lr[i] * wsd + lc[i]] : 0.f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!ok[i]) continue;
    const long long base = ((g0 + lr[i]) * g.w + c0 + lc[i]) * g.co;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int cout = co0 + tc * CPT + j;
      if (cout < g.co) y[base + cout] = acc[i][j];
    }
  }
}

template <int TC, int CPT, int PPT>
cudaError_t launch_simt(const float* x, const float* w, float* y, Geom g,
                        cudaStream_t stream) {
  constexpr int CO_T = TC * CPT;
  constexpr int P_T = (THREADS / TC) * PPT;   // output pixels per block
  g.tile_w = g.w < P_T ? g.w : P_T;
  g.rows = P_T / g.tile_w;
  g.col_tiles = (g.w + g.tile_w - 1) / g.tile_w;
  const long long bands = ((long long)g.n * g.h + g.rows - 1) / g.rows;
  const long long gx = bands * g.col_tiles;
  const long long gy = (g.co + CO_T - 1) / CO_T;
  const size_t smem =
      sizeof(float) * ((size_t)g.th * g.tw * SIMT_CI * CO_T +
                       (size_t)SIMT_CI * (g.rows + g.th - 1) * (g.tile_w + g.tw - 1));
  if (gx <= 0 || gx > INT_MAX || gy > 65535 || smem > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = simt_conv_kernel<TC, CPT, PPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)gx, (unsigned)gy), THREADS, smem, stream>>>(x, w, y, g);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// By shape only: float32 with co < 8 on the CUDA cores (faster there than
// an 8-wide tensor-core tile, which wins in bf16); else 128 pixels x 64
// channels for co > 32, 256 x 32 for co > 8, and 128 x 8.  The first two
// give every warp a 32 x 32 tile.
template <typename T>
int dispatch(const void* x, const void* w, void* y, int n, int h, int wd,
             int ci, int co, int th, int tw, int ph_lo, int pw_lo,
             void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (th > 32 || th < 1 || tw < 1) return (int)cudaErrorInvalidValue;
  Geom g{n, h, wd, ci, co, th, tw, ph_lo, pw_lo};
  g.vec_x = ci % vec<T>() == 0 && aligned16(x);
  g.vec_w = co % vec<T>() == 0 && aligned16(w);
  if constexpr (std::is_same<T, float>::value)
    if (co < 8) return (int)launch_simt<1, 4, 1>(xp, wp, yp, g, s);
  if (co > 32) return (int)launch_tc<T, 128, 64, 2>(xp, wp, yp, g, s);
  if (co > 8) return (int)launch_tc<T, 256, 32, 1>(xp, wp, yp, g, s);
  return (int)launch_tc<T, 128, 8, 1>(xp, wp, yp, g, s);
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
