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
// out (C,N) are float32, contiguous; any L, N, C, K >= 1.
//
// What bounds it on this card: the CUDA cores.  The squared distance is
// summed directly as (z - m)^2, a subtraction and an FMA per (l,c,n,k), so
// its floor is 2 L C N K instructions over 132 SMs x 128 lanes x 1.98 GHz
// (about 6.3 us at L=16, N=512, C=100, K=128); z is read once and the
// (L,C,N) weight tensor never reaches device memory, so bytes do not
// bound it.  The zz - 2zm + mm expansion (and TF32) are not used: with
// prior means at the flagship's scale (|m|^2 ~ 37,000) float32
// cancellation in the expansion loses ~1e-2 of the true class's term.
//
// What the design does about it:
// - Fill the card.  A block is 4 groups of 2 warps; each group reduces its
//   own share of l over the block's whole (32 class, 16 input) tile into a
//   running (max, sum).  Where too few (C, N) tiles exist, l is also split
//   across the blocks of a thread-block cluster (grid z; up to 16 blocks
//   where such clusters fill the card, else 8).  The groups merge in
//   shared memory, then each block of the cluster finishes a slice of the
//   tile from every block's partial through distributed shared memory:
//   (m1,s1)+(m2,s2) = (M, s1 e^(m1-M) + s2 e^(m2-M)), M = max(m1, m2).
//   One launch.  The split comes from a cost model of the SMs' load
//   (iws_combine_splits).  A warp whose classes all lie past C skips the
//   sum.
// - Tile in registers.  Each thread owns 4 classes x 2 inputs and reads
//   its rows of z and of the means as float4 along k: 6 shared loads feed
//   64 math instructions.  The sum runs in chunks of 16 k added to a total
//   (chains of 16 and K/16 terms: one running sum over K would take most
//   of the tolerance at the flagship's prior scale).  z rows are padded
//   to an odd number of float4s, so the 8 lanes of a load phase hit
//   distinct banks; the means are read by 8 lanes at once (broadcast).
// - Overlap the loads.  The block's class means stay in shared memory for
//   the whole reduction; each group double-buffers its next z slab with
//   cp.async (16-byte copies, 4-byte ones where K % 4 != 0 or a row is
//   not 16-byte aligned; pad columns stay zero and add nothing) and syncs
//   on its own named barrier.  Copy offsets advance by a fixed stride: no
//   div/mod per element.
//
// What still bounds it (H100, chip_smoke.py): the shared-memory loads.
// Each 128-bit load of a warp takes 4 passes, so a step of the inner loop
// costs a warp 24 passes of the SM's shared-memory pipe against 64 math
// instructions on its quarter of the SM: about 1.5 times the math.
// Larger register tiles (4 x 3, 4 x 4) ran slower at 128 registers.
//
// Large K (K > 352, where the resident means and the z slabs no longer fit
// in shared memory): the streamed kernel keeps the same tile, threads and
// sums, and streams k in chunks of KC = 128 through a double-buffered
// stage that holds the block's 32 class rows and each group's 16 z rows
// of one chunk.  The four groups walk their own l in step, one chunk at a
// time, behind one block barrier a chunk; each (l, class, input) distance
// stays in the thread's registers across the chunks, and the online
// (max, sum) update runs once the last chunk of its l is summed.  The
// chunks are multiples of 16 k, so the sum runs in the same chunks of 16
// added in the same order as in the resident kernel.  Streaming the means
// (rather than keeping them resident with fewer classes a block) keeps
// every K on one shared-memory size (about 99 KiB, two blocks an SM); the
// means are read once per l step and chunk from L2, C K floats, against
// the group's NT K floats of z.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GROUPS = 4;                 // warp groups, each its own l share
constexpr int GT = 64;                    // threads per group: 2 warps
constexpr int THREADS = GROUPS * GT;
constexpr int TC = 4;                     // classes per thread
constexpr int TN = 2;                     // inputs per thread
constexpr int CT = 8 * TC;                // classes per block
constexpr int NT = 8 * TN;                // inputs per block
constexpr int TILE = CT * NT;
constexpr int MAX_SPLITS = 16;            // cluster blocks, non-portable > 8
constexpr int SMEM_LIMIT = 232448;        // bytes a block may use
constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float NEG = -1e30f;             // running max before any l
constexpr int KC = 128;                   // k per chunk of the streamed kernel
constexpr int KCP = KC + 4;               // its row stride: 33 float4s (odd)
constexpr int STAGE = (CT + GROUPS * NT) * KCP;  // floats of one stage

// float4s of a row that the sum reads: K rounded up to 16, zero-padded
__host__ __device__ inline int row_quads(int K) { return 4 * ((K + 15) >> 4); }

// row stride in floats: an odd count of float4s (no bank conflicts)
__host__ __device__ inline int row_stride(int K) {
  return 4 * (row_quads(K) | 1);
}

// shared floats: the means, then the slabs (later reused for the merge)
inline size_t smem_bytes(int K) {
  const size_t kp = row_stride(K);
  const size_t slabs = (size_t)GROUPS * 2 * NT * kp;
  const size_t merge = (size_t)(2 * GROUPS + 2) * TILE;
  return sizeof(float) * (CT * kp + (slabs > merge ? slabs : merge));
}

// the streamed kernel's: two stages (later reused for the merge)
inline size_t smem_bytes_streamed() {
  const size_t stages = 2 * (size_t)STAGE;
  const size_t merge = (size_t)(2 * GROUPS + 2) * TILE;
  return sizeof(float) * (stages > merge ? stages : merge);
}

// the resident kernel where its means and slabs fit, else the streamed one
// (built with IWS_ALWAYS_STREAMED, the streamed one at every K, to time
// the two at one shape: scripts/time_torch_iws.py --streamed)
inline bool streamed(int K) {
#ifdef IWS_ALWAYS_STREAMED
  return true;
#else
  return smem_bytes(K) > (size_t)SMEM_LIMIT;
#endif
}

__device__ inline void cp_async(float* dst, const float* src, bool valid,
                                int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;        // 0: fill the destination with 0
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(GT) : "memory");
}

// rows [0, rows) of a (rows_total, K) matrix from row r0 into shared rows
// of kp floats, by `nthreads` threads starting at `t`; rows past `rows_total`
// are zero-filled
template <bool VEC>
__device__ inline void stage_rows(float* dst, const float* src, int r0,
                                  int rows, int rows_total, int K, int kp,
                                  int t, int nthreads) {
  const int per_row = VEC ? K / 4 : K;    // copies per row
  const int width = VEC ? 4 : 1;
  int r = t / per_row, q = t - r * per_row;
  const int dr = nthreads / per_row, dq = nthreads - dr * per_row;
  while (r < rows) {
    const bool valid = r0 + r < rows_total;
    const float* s = valid ? src + (long long)(r0 + r) * K + q * width : src;
    cp_async(dst + r * kp + q * width, s, valid, 4 * width);
    q += dq;
    r += dr;
    if (q >= per_row) {
      q -= per_row;
      ++r;
    }
  }
}

// d2 += the squared distances (z - m)^2 of the thread's TC classes and TN
// inputs over float4s [0, nq) of their shared rows (z rows `zs` float4s
// apart, means rows `ms` apart), summed in chunks of 16 k added to the
// total: the rounding of chains of 16 and of K/16 terms rather than of
// one chain of K
__device__ __forceinline__ void add_distances(float (&d2)[TC][TN],
                                              const float4* zrow, int zs,
                                              const float4* mrow, int ms,
                                              int nq) {
  for (int q0 = 0; q0 < nq; q0 += 4) {
    float acc[TC][TN];
#pragma unroll
    for (int j = 0; j < TC; ++j)
#pragma unroll
      for (int i = 0; i < TN; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int q = q0; q < q0 + 4; ++q) {
      float4 zv[TN], mv[TC];
#pragma unroll
      for (int i = 0; i < TN; ++i) zv[i] = zrow[8 * i * zs + q];
#pragma unroll
      for (int j = 0; j < TC; ++j) mv[j] = mrow[j * ms + q];
#pragma unroll
      for (int j = 0; j < TC; ++j)
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          float d = zv[i].x - mv[j].x;
          acc[j][i] = fmaf(d, d, acc[j][i]);
          d = zv[i].y - mv[j].y;
          acc[j][i] = fmaf(d, d, acc[j][i]);
          d = zv[i].z - mv[j].z;
          acc[j][i] = fmaf(d, d, acc[j][i]);
          d = zv[i].w - mv[j].w;
          acc[j][i] = fmaf(d, d, acc[j][i]);
        }
    }
#pragma unroll
    for (int j = 0; j < TC; ++j)
#pragma unroll
      for (int i = 0; i < TN; ++i) d2[j][i] += acc[j][i];
  }
}

// log_pxq[l, n] of the thread's TN inputs (0 past N)
__device__ __forceinline__ void load_lp(float (&lpv)[TN],
                                        const float* __restrict__ lp, int l,
                                        int N, int n0, int tn) {
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int n = n0 + tn + 8 * i;
    lpv[i] = n < N ? __ldg(lp + (long long)l * N + n) : 0.f;
  }
}

// the online (max, sum) update with one l's log weights
// w = log_pxq + const_c - 0.5 s2_c d2
__device__ __forceinline__ void online_update(float (&rm)[TC][TN],
                                              float (&rs)[TC][TN],
                                              const float (&d2)[TC][TN],
                                              const float (&lpv)[TN],
                                              const float (&cst)[TC],
                                              const float (&s2c)[TC]) {
#pragma unroll
  for (int j = 0; j < TC; ++j)
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const float w = lpv[i] + cst[j] - 0.5f * s2c[j] * d2[j][i];
      const float e = expf(-fabsf(w - rm[j][i]));
      const bool up = w > rm[j][i];
      rs[j][i] = up ? fmaf(rs[j][i], e, 1.f) : rs[j][i] + e;
      rm[j][i] = up ? w : rm[j][i];
    }
}

__device__ inline void merge(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2);
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

// Merge the groups' (max, sum) of the block's tile in shared memory
// (`region`, free once every group's last stage is read), then the
// cluster's blocks, and write out[c, n]
__device__ __forceinline__ void finish(float* region, const float (&rm)[TC][TN],
                                       const float (&rs)[TC][TN],
                                       float* __restrict__ out, int L, int N,
                                       int C, int n0, int c0, int tid, int g,
                                       int tn, int tc, int ref_mode) {
  const int S = gridDim.z;
  float* pm = region;                     // [GROUPS][TILE]
  float* ps = pm + GROUPS * TILE;
  float* bm = ps + GROUPS * TILE;         // [TILE], read by the cluster
  float* bs = bm + TILE;
#pragma unroll
  for (int j = 0; j < TC; ++j)
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const int e = (TC * tc + j) * NT + tn + 8 * i;
      pm[g * TILE + e] = rm[j][i];
      ps[g * TILE + e] = rs[j][i];
    }
  __syncthreads();
  for (int e = tid; e < TILE; e += THREADS) {
    float m = pm[e], s = ps[e];
    for (int h = 1; h < GROUPS; ++h)
      merge(m, s, pm[h * TILE + e], ps[h * TILE + e]);
    bm[e] = m;
    bs[e] = s;
  }
  // each block of the cluster finishes a slice of the tile from every
  // block's partial, its S remote loads issued together
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int slice = (TILE + S - 1) / S;
  const int e_end = min(TILE, ((int)cluster.block_rank() + 1) * slice);
  for (int e = cluster.block_rank() * slice + tid; e < e_end; e += THREADS) {
    float pmr[MAX_SPLITS], psr[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < S) {
        pmr[r] = cluster.map_shared_rank(bm, r)[e];
        psr[r] = cluster.map_shared_rank(bs, r)[e];
      }
    float m = pmr[0], s = 0.f;
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r)
      if (r < S) m = fmaxf(m, pmr[r]);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < S) s += psr[r] * expf(pmr[r] - m);
    const int c = c0 + e / NT, n = n0 + e % NT;
    if (c < C && n < N) {
      const float me = s / (float)L;
      out[(long long)c * N + n] = ref_mode ? me + m : logf(me) + m;
    }
  }
  cluster.sync();                         // peers' shared memory stays live
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
iws_combine_kernel(const float* __restrict__ z, const float* __restrict__ lp,
                   const float* __restrict__ mean,
                   const float* __restrict__ s2,
                   const float* __restrict__ ldp, float* __restrict__ out,
                   int L, int N, int K, int C, int ref_mode) {
  extern __shared__ __align__(16) float smem[];
  const int kp = row_stride(K);
  float* ms = smem;                       // [CT][kp]
  float* region = smem + CT * kp;         // slabs [GROUPS][2][NT][kp]
  const int n0 = blockIdx.x * NT;
  const int c0 = blockIdx.y * CT;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int g = tid / GT;
  const int gt = tid % GT;
  const int tn = gt & 7;                  // inputs tn + 8 i
  const int tc = gt >> 3;                 // classes TC tc + j
  const int kq = row_quads(K);
  // a warp whose classes all lie past C (the last class tile) skips the sum
  const int kq_busy = c0 + TC * (tc & ~3) < C ? kq : 0;

  for (int r = tid; r < CT + GROUPS * 2 * NT; r += THREADS)
    for (int k = K; k < 4 * kq; ++k) smem[r * kp + k] = 0.f;  // pads stay 0
  stage_rows<VEC>(ms, mean, c0, CT, C, K, kp, tid, THREADS);
  cp_async_commit();

  float* slabs = region + 2 * g * NT * kp;  // this group's two buffers
  const int lstep = S * GROUPS;
  int l = blockIdx.z * GROUPS + g;
  if (l < L)
    stage_rows<VEC>(slabs, z + (long long)l * N * K, n0, NT, N, K, kp, gt,
                    GT);
  cp_async_commit();

  float cst[TC], s2c[TC], rm[TC][TN], rs[TC][TN];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = c0 + TC * tc + j;
    const bool valid = c < C;
    s2c[j] = valid ? s2[c] : 0.f;
    cst[j] = valid ? -0.5f * K * LOG_2PI - 0.5f * ldp[c] : 0.f;
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      rm[j][i] = NEG;
      rs[j][i] = 0.f;
    }
  }
  cp_async_wait<1>();                     // the means
  __syncthreads();

  const float4* mrow = reinterpret_cast<const float4*>(ms + TC * tc * kp);
  const int kp4 = kp / 4;
  for (int b = 0; l < L; l += lstep, b ^= 1) {
    const int ln = l + lstep;
    if (ln < L)
      stage_rows<VEC>(slabs + (b ^ 1) * NT * kp, z + (long long)ln * N * K,
                      n0, NT, N, K, kp, gt, GT);
    cp_async_commit();
    float lpv[TN];
    load_lp(lpv, lp, l, N, n0, tn);
    cp_async_wait<1>();                   // this step's slab
    group_sync(g);

    const float4* zrow = reinterpret_cast<const float4*>(
        slabs + b * NT * kp + tn * kp);
    float d2[TC][TN];
#pragma unroll
    for (int j = 0; j < TC; ++j)
#pragma unroll
      for (int i = 0; i < TN; ++i) d2[j][i] = 0.f;
    add_distances(d2, zrow, kp4, mrow, kp4, kq_busy);
    online_update(rm, rs, d2, lpv, cst, s2c);
    group_sync(g);                        // slab b is free for step + 2
  }
  cp_async_wait<0>();
  __syncthreads();
  finish(region, rm, rs, out, L, N, C, n0, c0, tid, g, tn, tc, ref_mode);
}

// chunk [k0, k0 + width) of rows [0, rows) of a (rows_total, K) matrix
// from row r0 into shared rows of KCP floats, by `nthreads` threads
// starting at `t`; rows past `rows_total` and columns past K are
// zero-filled (width a multiple of 16)
template <bool VEC>
__device__ inline void stage_chunk(float* dst, const float* src, int r0,
                                   int rows, int rows_total, int K, int k0,
                                   int width, int t, int nthreads) {
  const int per_row = VEC ? width / 4 : width;   // copies per row
  const int w = VEC ? 4 : 1;
  int r = t / per_row, q = t - r * per_row;
  const int dr = nthreads / per_row, dq = nthreads - dr * per_row;
  while (r < rows) {
    const int k = k0 + q * w;
    const bool valid = r0 + r < rows_total && k < K;
    const float* s = valid ? src + (long long)(r0 + r) * K + k : src;
    cp_async(dst + r * KCP + q * w, s, valid, 4 * w);
    q += dq;
    r += dr;
    if (q >= per_row) {
      q -= per_row;
      ++r;
    }
  }
}

// item t's stage of the streamed kernel: the means' chunk by the block,
// each group's z chunk of its own l by the group
template <bool VEC>
__device__ inline void stage_item(float* smem, const float* z,
                                  const float* mean, int t, int nch, int kq,
                                  int l0, int lstep, int L, int N, int K,
                                  int C, int n0, int c0, int tid, int g,
                                  int gt) {
  constexpr int KCQ = KC / 4;
  float* buf = smem + (t & 1) * STAGE;
  const int step = t / nch, ch = t - step * nch;
  const int width = 4 * min(KCQ, kq - ch * KCQ);
  stage_chunk<VEC>(buf, mean, c0, CT, C, K, ch * KC, width, tid, THREADS);
  const int l = l0 + step * lstep;
  if (l < L)
    stage_chunk<VEC>(buf + (CT + g * NT) * KCP, z + (long long)l * N * K, n0,
                     NT, N, K, ch * KC, width, gt, GT);
}

// The streamed kernel (any K; the planner takes it where the resident
// one's shared memory would not fit).  Item t of a block is (l step
// t / nch, chunk t % nch); every group stages and sums its own l's chunk
// of the item, the means' chunk shared by all.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
iws_combine_streamed_kernel(const float* __restrict__ z,
                            const float* __restrict__ lp,
                            const float* __restrict__ mean,
                            const float* __restrict__ s2,
                            const float* __restrict__ ldp,
                            float* __restrict__ out, int L, int N, int K,
                            int C, int ref_mode) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * NT;
  const int c0 = blockIdx.y * CT;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int g = tid / GT;
  const int gt = tid % GT;
  const int tn = gt & 7;                  // inputs tn + 8 i
  const int tc = gt >> 3;                 // classes TC tc + j
  const int kq = row_quads(K);
  constexpr int KCQ = KC / 4;             // float4s a chunk
  const int nch = (kq + KCQ - 1) / KCQ;
  const bool busy = c0 + TC * (tc & ~3) < C;
  const int lstep = S * GROUPS;
  const int l0 = blockIdx.z * GROUPS + g;   // this group's first l
  const int steps = (L - blockIdx.z * GROUPS + lstep - 1) / lstep;
  const int items = steps * nch;

  float cst[TC], s2c[TC], rm[TC][TN], rs[TC][TN], d2[TC][TN];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = c0 + TC * tc + j;
    const bool valid = c < C;
    s2c[j] = valid ? s2[c] : 0.f;
    cst[j] = valid ? -0.5f * K * LOG_2PI - 0.5f * ldp[c] : 0.f;
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      rm[j][i] = NEG;
      rs[j][i] = 0.f;
      d2[j][i] = 0.f;
    }
  }
  stage_item<VEC>(smem, z, mean, 0, nch, kq, l0, lstep, L, N, K, C, n0, c0,
                  tid, g, gt);
  cp_async_commit();
  for (int t = 0; t < items; ++t) {
    if (t + 1 < items)
      stage_item<VEC>(smem, z, mean, t + 1, nch, kq, l0, lstep, L, N, K, C,
                      n0, c0, tid, g, gt);
    cp_async_commit();
    cp_async_wait<1>();                   // item t's stage
    __syncthreads();
    const int step = t / nch, ch = t - step * nch;
    const int l = l0 + step * lstep;
    const float* buf = smem + (t & 1) * STAGE;
    if (busy && l < L) {
      const float4* mrow =
          reinterpret_cast<const float4*>(buf + TC * tc * KCP);
      const float4* zrow = reinterpret_cast<const float4*>(
          buf + (CT + g * NT + tn) * KCP);
      add_distances(d2, zrow, KCP / 4, mrow, KCP / 4,
                    min(KCQ, kq - ch * KCQ));
    }
    if (ch == nch - 1) {                  // l's distances are whole
      if (l < L) {
        float lpv[TN];
        load_lp(lpv, lp, l, N, n0, tn);
        online_update(rm, rs, d2, lpv, cst, s2c);
      }
#pragma unroll
      for (int j = 0; j < TC; ++j)
#pragma unroll
        for (int i = 0; i < TN; ++i) d2[j][i] = 0.f;
    }
    __syncthreads();                      // stage t & 1 is free for t + 2
  }
  cp_async_wait<0>();
  __syncthreads();
  finish(smem, rm, rs, out, L, N, C, n0, c0, tid, g, tn, tc, ref_mode);
}

using Kernel = void (*)(const float*, const float*, const float*,
                       const float*, const float*, float*, int, int, int, int,
                       int);

Kernel kernel_for(int K, bool vec) {
  if (streamed(K))
    return vec ? iws_combine_streamed_kernel<true>
               : iws_combine_streamed_kernel<false>;
  return vec ? iws_combine_kernel<true> : iws_combine_kernel<false>;
}

// What a launch at one K can count on (cached per device, K and copy width):
// the SM count, blocks per SM, and how many clusters of each split the
// card holds at once
struct Occupancy {
  int K = -1;
  int sms = 0;
  int resident = 0;
  int active[MAX_SPLITS + 1] = {};
};
Occupancy g_occupancy[64][2];

cudaError_t occupancy(int K, bool vec, const Occupancy** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Occupancy& o = g_occupancy[dev][vec];
  *out = &o;
  if (o.K == K) return cudaSuccess;
  e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = streamed(K) ? smem_bytes_streamed() : smem_bytes(K);
  const Kernel kernel = kernel_for(K, vec);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.resident, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return e;
  o.active[1] = o.sms * o.resident;
  for (int s = 2; s <= MAX_SPLITS; ++s) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = s;
    cfg.gridDim = dim3(1, 1, s);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&o.active[s], kernel, &cfg);
    if (e != cudaSuccess) return e;
  }
  o.K = K;
  return cudaSuccess;
}

// The split of l across a cluster's blocks, from a model of the busiest
// SM measured on the H100 (chip_smoke.py): waves of the clusters the card
// holds at once, each costing the SM's blocks times each group's l steps
// plus about two steps of fixed cost (staging the means, the merges).
// The card packs a cluster's blocks onto as few SMs as it can, so once a
// wave holds more than half as many blocks as SMs, count an SM as full.
// Ties go to the larger split (more warps).
int choose_splits(int L, int tiles, const Occupancy& o) {
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int s = 1; s <= MAX_SPLITS && (s - 1) * GROUPS < L; ++s) {
    if (o.active[s] < 1) break;
    const long long held = tiles < o.active[s] ? tiles : o.active[s];
    const long long waves = (tiles + held - 1) / held;
    const long long in_wave = s * held;
    const long long per_sm = s > 1 && 2 * in_wave > o.sms
                                 ? o.resident
                                 : (in_wave + o.sms - 1) / o.sms;
    const long long steps = (L + (long long)s * GROUPS - 1) / (s * GROUPS);
    const long long cost = waves * (per_sm * steps + 2);
    if (cost <= best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

cudaError_t plan(int L, int N, int K, int C, bool vec, dim3* grid,
                 size_t* smem) {
  if (L <= 0 || N <= 0 || K <= 0 || C <= 0) return cudaErrorInvalidValue;
  *smem = streamed(K) ? smem_bytes_streamed() : smem_bytes(K);
  const long long ntiles = (N + NT - 1) / NT, ctiles = (C + CT - 1) / CT;
  if (ntiles > INT_MAX || ctiles > 65535) return cudaErrorInvalidValue;
  const Occupancy* o = nullptr;
  const cudaError_t e = occupancy(K, vec, &o);
  if (e != cudaSuccess) return e;
  const int tiles = (int)(ntiles * ctiles < INT_MAX ? ntiles * ctiles
                                                  : INT_MAX);
  *grid = dim3((unsigned)ntiles, (unsigned)ctiles,
               choose_splits(L, tiles, *o));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The split of l across blocks that a launch at this shape uses, or a
// negative cudaError_t.
int iws_combine_splits(int L, int N, int K, int C) {
  dim3 grid;
  size_t smem = 0;
  const cudaError_t e = plan(L, N, K, C, K % 4 == 0, &grid, &smem);
  return e == cudaSuccess ? (int)grid.z : -(int)e;
}

int iws_combine_f32(const void* z, const void* lp, const void* mean,
                    const void* s2, const void* ldp, void* out, int L, int N,
                    int K, int C, int ref_mode, void* stream) {
  // 16-byte copies need K % 4 == 0 and 16-byte aligned rows
  const uintptr_t rows = reinterpret_cast<uintptr_t>(z) |
                         reinterpret_cast<uintptr_t>(mean);
  const bool vec = K % 4 == 0 && (rows & 15) == 0;
  dim3 grid;
  size_t smem = 0;
  cudaError_t e = plan(L, N, K, C, vec, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* zf = static_cast<const float*>(z);
  const float* lpf = static_cast<const float*>(lp);
  const float* mf = static_cast<const float*>(mean);
  const float* s2f = static_cast<const float*>(s2);
  const float* ldpf = static_cast<const float*>(ldp);
  float* of = static_cast<float*>(out);
  e = cudaLaunchKernelEx(&cfg, kernel_for(K, vec), zf, lpf, mf, s2f, ldpf,
                         of, L, N, K, C, ref_mode);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
