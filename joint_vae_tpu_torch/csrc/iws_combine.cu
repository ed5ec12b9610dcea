// Per-class IWAE combine for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel joint_vae_tpu/ops/pallas_kernels.py (iws_fused /
// _iws_kernel).  For a class-conditional gaussian prior with scalar
// variance the log importance weight is
//
//   log w[l,c,n] = log_pxq[l,n] + const_c - 0.5 * s2_c * ||z[l,n] - m_c||^2,
//   const_c = -0.5 * K * log(2 pi) - 0.5 * log_det_prior_c,
//
// and out[c,n] reduces over l with an online (max, sum): log-mean-exp, or
// with ref_mode the reference's published mean-exp + max (no log).
// z (L,N,K), log_pxq (L,N), mean (C,K), s2 (C,), log_det_prior (C,) and
// out (C,N) are float32, contiguous; C and N need not be tile multiples.
//
// What bounds it on this card: ~3 FLOPs per (l,c,n,k) against one read of
// z, so arithmetic bounds it (a few microseconds at L=16, N=512, C=100,
// K=128); at that size launch latency is of the same order.  The (L,C,N)
// weight tensor that a plain combine materializes never reaches device
// memory.
//
// What the design does about it: the grid is (C tile, N tile); a loop
// inside the block over all L replaces the TPU's sequential L grid axis,
// and the running max and sum stay in registers.  The block's 16 class
// means sit in shared memory for the whole loop and each l's 32 z rows
// are staged there (rows padded to K+1 words: no bank conflicts).  The
// squared distance is summed directly as (z - m)^2 on the CUDA cores,
// which is more precise than the zz - 2zm + mm expansion.  Ragged C and N
// are masked by bounds checks; no -1e30 padding is needed.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;              // 4 warps
constexpr int NT = 32;                    // inputs per block: one per lane
constexpr int CT = 16;                    // classes per block
constexpr int WARPS = THREADS / 32;
constexpr int CPW = CT / WARPS;           // classes per thread
constexpr float LOG_2PI = 1.8378770664093453f;

__global__ void __launch_bounds__(THREADS)
iws_combine_kernel(const float* __restrict__ z, const float* __restrict__ lp,
                   const float* __restrict__ mean,
                   const float* __restrict__ s2,
                   const float* __restrict__ ldp, float* __restrict__ out,
                   int L, int N, int K, int C, int ref_mode) {
  extern __shared__ float smem[];
  const int ks = K + 1;
  float* ms = smem;               // [CT][ks]
  float* zs = smem + CT * ks;     // [NT][ks]
  const int c0 = blockIdx.x * CT;
  const int n0 = blockIdx.y * NT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wq = tid >> 5;
  const int n = n0 + lane;

  for (int idx = tid; idx < CT * K; idx += THREADS) {
    const int c = idx / K, k = idx % K;
    ms[c * ks + k] = (c0 + c < C) ? mean[(long long)(c0 + c) * K + k] : 0.f;
  }

  float s2c[CPW], constc[CPW], rmax[CPW], rsum[CPW];
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const int c = c0 + wq + WARPS * j;
    const bool valid = c < C;
    s2c[j] = valid ? s2[c] : 0.f;
    constc[j] = valid ? -0.5f * K * LOG_2PI - 0.5f * ldp[c] : 0.f;
    rmax[j] = -1e30f;
    rsum[j] = 0.f;
  }

  for (int l = 0; l < L; ++l) {
    __syncthreads();
    for (int idx = tid; idx < NT * K; idx += THREADS) {
      const int r = idx / K, k = idx % K;
      zs[r * ks + k] =
          (n0 + r < N) ? z[((long long)l * N + n0 + r) * K + k] : 0.f;
    }
    __syncthreads();
    float d2[CPW];
#pragma unroll
    for (int j = 0; j < CPW; ++j) d2[j] = 0.f;
    const float* zr = zs + lane * ks;
    for (int k = 0; k < K; ++k) {
      const float zv = zr[k];
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const float d = zv - ms[(wq + WARPS * j) * ks + k];
        d2[j] = fmaf(d, d, d2[j]);
      }
    }
    const float lpv = (n < N) ? lp[(long long)l * N + n] : 0.f;
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const float w = lpv + constc[j] - 0.5f * s2c[j] * d2[j];
      const float nm = fmaxf(rmax[j], w);
      rsum[j] = rsum[j] * expf(rmax[j] - nm) + expf(w - nm);
      rmax[j] = nm;
    }
  }

  if (n >= N) return;
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const int c = c0 + wq + WARPS * j;
    if (c >= C) continue;
    const float me = rsum[j] / (float)L;
    out[(long long)c * N + n] = ref_mode ? me + rmax[j] : logf(me) + rmax[j];
  }
}

}  // namespace

extern "C" {

int iws_combine_f32(const void* z, const void* lp, const void* mean,
                    const void* s2, const void* ldp, void* out, int L, int N,
                    int K, int C, int ref_mode, void* stream) {
  if (L <= 0 || N <= 0 || K <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + CT - 1) / CT, (N + NT - 1) / NT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(CT + NT) * (K + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        iws_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  iws_combine_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(lp),
      static_cast<const float*>(mean), static_cast<const float*>(s2),
      static_cast<const float*>(ldp), static_cast<float*>(out), L, N, K, C,
      ref_mode);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
