// Same-grid NHWC convolution for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel joint_vae_tpu/ops/pallas_conv.py
// (_same_grid_conv_impl / _kernel_body): a stride-(1,1) conv whose output
// grid equals its input grid, y[n,i,j,o] = sum_{a,b,c} x[n, i+a-ph_lo,
// j+b-pw_lo, c] * w[a,b,c,o] with zeros outside the image, pads
// (ph_lo, th-1-ph_lo) x (pw_lo, tw-1-pw_lo), possibly asymmetric.  No bias.
// x (n,h,w,ci) and w (th,tw,ci,co) are float32 or bfloat16, contiguous;
// y (n,h,w,co) is in the input type; accumulation is float32.
//
// What bounds it on this card: at the model's shapes (5x5 taps, 32-64
// channels) each output value costs 2*25*ci FLOPs (1,600-3,200) against a
// few bytes of input and output moved, so arithmetic bounds it, not
// device memory.  This first version runs on the CUDA cores in float32
// (67 TFLOP/s peak); the tensor cores (wgmma) are left to a later change.
//
// What the design does about it: a block owns a band of output rows
// (flattened over n*h, so small images pack several per block and no
// thread idles on an 8x8 image) times a tile of output channels.  Per
// chunk of 8 input channels it stages the band's input rows plus the
// halo, and that chunk of every tap's weights, in shared memory (float32,
// bf16 converted on load), then each thread accumulates a register tile of
// PPT pixels x CPT channels.  Warps run 32 consecutive pixels against one
// channel group, so input reads are consecutive words and weight reads are
// broadcasts (a float4 per 4 channels).  Halo rows that belong to a
// neighbouring image are masked per tap row, as the TPU kernel masks its
// flat row shifts; halo columns are zero-filled when staged.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CI_C = 8;          // input channels staged per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Geom {
  int n, h, w, ci, co, th, tw, ph_lo, pw_lo;
  int rows;        // output rows per block (rows of the flattened n*h grid)
  int tile_w;      // output columns per block
  int col_tiles;   // column tiles per row band
};

// TC thread groups along channels, CPT channels and PPT pixels per thread.
template <int TC, int CPT, int PPT, typename T>
__global__ void __launch_bounds__(THREADS)
same_grid_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      T* __restrict__ y, Geom g) {
  constexpr int TP = THREADS / TC;       // threads along pixels
  constexpr int CO_T = TC * CPT;         // output channels per block
  extern __shared__ __align__(16) float smem[];

  const int taps = g.th * g.tw;
  const int hr = g.rows + g.th - 1;      // staged input rows
  const int wsd = g.tile_w + g.tw - 1;   // staged input columns
  const int plane = hr * wsd;
  float* ws = smem;                           // [taps][CI_C][CO_T]
  float* xs = smem + taps * CI_C * CO_T;      // [CI_C][hr][wsd]

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

  for (int ci0 = 0; ci0 < g.ci; ci0 += CI_C) {
    __syncthreads();
    for (int idx = tid; idx < taps * CI_C * CO_T; idx += THREADS) {
      const int o = idx % CO_T;
      const int r = idx / CO_T;
      const int c = r % CI_C, tap = r / CI_C;
      const int cin = ci0 + c, cout = co0 + o;
      float v = 0.f;
      if (cin < g.ci && cout < g.co)
        v = to_f32(wt[((long long)tap * g.ci + cin) * g.co + cout]);
      ws[idx] = v;
    }
    for (int idx = tid; idx < CI_C * plane; idx += THREADS) {
      const int c = idx % CI_C;
      const int r = idx / CI_C;
      const int col = r % wsd, row = r / wsd;
      const long long gr = g0 - g.ph_lo + row;
      const int gc = c0 - g.pw_lo + col;
      const int cin = ci0 + c;
      float v = 0.f;
      if (gr >= 0 && gr < total_rows && gc >= 0 && gc < g.w && cin < g.ci)
        v = to_f32(x[(gr * g.w + gc) * g.ci + cin]);
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
        const float* wtap = ws + (a * g.tw + b) * CI_C * CO_T + tc * CPT;
        const float* xtap = xs + a * wsd + b;
#pragma unroll
        for (int c = 0; c < CI_C; ++c) {
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
      if (cout < g.co) store_f32(&y[base + cout], acc[i][j]);
    }
  }
}

template <int TC, int CPT, int PPT, typename T>
cudaError_t launch(const T* x, const T* w, T* y, int n, int h, int wd, int ci,
                   int co, int th, int tw, int ph_lo, int pw_lo,
                   cudaStream_t stream) {
  constexpr int CO_T = TC * CPT;
  constexpr int P_T = (THREADS / TC) * PPT;   // output pixels per block
  Geom g{n, h, wd, ci, co, th, tw, ph_lo, pw_lo, 0, 0, 0};
  g.tile_w = wd < P_T ? wd : P_T;
  g.rows = P_T / g.tile_w;
  g.col_tiles = (wd + g.tile_w - 1) / g.tile_w;
  const long long bands = ((long long)n * h + g.rows - 1) / g.rows;
  const long long gx = bands * g.col_tiles;
  const long long gy = (co + CO_T - 1) / CO_T;
  if (gx <= 0 || gx > INT_MAX || gy > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)th * tw * CI_C * CO_T +
                       (size_t)CI_C * (g.rows + th - 1) * (g.tile_w + tw - 1));
  auto kern = same_grid_conv_kernel<TC, CPT, PPT, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)gx, (unsigned)gy), THREADS, smem, stream>>>(x, w, y, g);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, int n, int h, int wd,
             int ci, int co, int th, int tw, int ph_lo, int pw_lo,
             void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co >= 16)   // 32 channels x 128 pixels per block, 4x4 per thread
    return (int)launch<8, 4, 4, T>(xp, wp, yp, n, h, wd, ci, co, th, tw,
                                   ph_lo, pw_lo, s);
  // few output channels (e.g. the RGB head): 4 channels x 256 pixels
  return (int)launch<1, 4, 1, T>(xp, wp, yp, n, h, wd, ci, co, th, tw, ph_lo,
                                 pw_lo, s);
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
