// CUDA C++ kernels of the fused-Hessian packed evaluate, for sm_90a.
//
// All three compute one function of the packed layout (see
// packed_kernels.cu for the arrays): the rank rows of every (scan, plane)
// -- rows_point, the same device body as B2 `rows` -- and, without ever
// writing the rows to device memory,
//   Htilde = sum_k M_k M_k^T,  M_k (6Wp, Gp) with row j * Wp + w,
// plus J (Wp, 6) and D (Wp, 36), the sums over planes of the gradient and
// block-diagonal channels.  Htilde is (j, w)-major like the TPU kernels'.
//
// What bounds them on the H100: operations.  At Wp = 256, Gp = 11520 the
// symmetric Htilde needs only its lower triangle, 1536 * 1537 * 34560 =
// 81.6 GFLOP, 1.22 ms at the card's 67 TFLOP/s fp32 (non-tensor-core)
// peak, against ~0.04 ms to read `mom` (118 MB) once.  B4 and B6 compute
// every entry (2 * 1536^2 * 34560 = 163.1 GFLOP), B5 every entry of its
// pairs (122.3 GFLOP at Wp = 256).  A fused kernel also rebuilds the rows of its output
// tile's scans once per tile: ~870 FLOP per (scan, plane), 2.57 GFLOP per
// pass over the problem, 2 * (Wp / BT) passes for tiles of BT scans on a
// side -- 82 GFLOP at BT = 16, 41 GFLOP at BT = 32.
//
// Common body (tile_accumulate): a block of 256 threads owns an output
// tile of BT scans on each side, (6 BT) x (6 BT) entries of Htilde.  For
// each chunk of BK = 256 / BT planes every thread builds the 18 row values
// of one (scan, plane) of each side with rows_point into shared memory,
// in (k, plane) x (j, scan) order, then each thread adds its
// (6 BT / 16)^2 micro-tile of A B^T in registers with fp32 FMA, flushed
// into the block's own output entries every 384 terms (tile_accumulate).
// The product is the exact fp32 one: no tensor cores, no TF32, no split.  On a
// tile whose two sides are the same scans the rows are built once, and
// the block also sums J and D of those scans: each thread adds its point's
// 42 channels to its own slots in shared memory, and the slots are summed
// in a fixed order at the end.  No atomics anywhere, so two runs give the
// same Htilde, J and D.
//
// B4 `hess_v2` replaces the Pallas `_hess_kernel_v2` (balm_tpu/ops/
// pallas_evaluate.py:491, wrapper hess_packed_v2 :552): rows never leave
// the chip and the whole plane axis is accumulated on chip.  One block per
// output tile of the full Htilde (BT = 16: 256 tiles at Wp = 256, enough to
// fill 132 SMs), each walking every plane; J and D from the diagonal tiles.
//
// B5 `hess_v3` replaces the Pallas `_hess_kernel_v3` (:604, wrapper
// hess_packed_v3 :697): the lower triangle of pose-block pairs at Bw scans
// (Bw = 128 by default), each pair's (6 Bw) x (6 Bw) block split over
// (Bw / 16)^2 blocks of threads, each walking every plane.  It writes the
// raw pair blocks, (j, w)-major inside each; J and D come from the
// diagonal sub-tiles of diagonal pairs: 3 of 4 pairs at Wp = 256, whose
// two diagonal pairs are computed in full.  The mirror into the full matrix
// is glue (ops/packed_evaluate.py).
//
// B6 `hess_v1` replaces the Pallas `_hess_kernel` (:284, wrapper
// hess_packed :444): per plane split a partial Htilde, summed.  Output
// tiles are BT = 32 scans on a side (half B4's rebuild), and the plane
// axis is cut into as many splits as it takes to put two blocks on every
// SM; each (tile, split) block writes a partial Htilde and partial J, D,
// and a second pass sums the partials in split order.
//
// Build: see packed_kernels.cu (one nvcc call builds both files).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows_point.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block: 16 x 16 for the product
constexpr int kJDc = 42;        // J (6) + D (36) channels per scan

template <int BT>
struct Tile {
  static constexpr int BK = kThreads / BT;  // planes per chunk
  static constexpr int KD = 3 * BK;         // product depth per chunk
  static constexpr int N = 6 * BT;          // tile side
  static constexpr int LD = N + 4;          // shared row stride (banks)
  static constexpr int TM = N / 16;         // micro-tile side per thread
  static constexpr int kSmemFloats = 2 * KD * LD + kJDc * kThreads;
};

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Rows of one (scan w, plane g) into S[(3 gl + k) * LD + j * BT + wl]; with
// JD the point's J and D channels are added to this thread's slots.
template <int BT, bool JD>
__device__ __forceinline__ void build_point(
    const float* __restrict__ pose, const float* __restrict__ mom,
    const float* __restrict__ cen, const float* __restrict__ aux,
    int64_t Gp, int64_t w, bool live, int64_t g, int wl, int gl,
    float* __restrict__ S, float* __restrict__ jd) {
  using T = Tile<BT>;
  float rw[6][3];
  if (live) {
    float r[12], m[10], c[3], ax[17];
    for (int i = 0; i < 12; ++i) r[i] = pose[w * 12 + i];
    for (int i = 0; i < 10; ++i) m[i] = mom[(w * 10 + i) * Gp + g];
    for (int i = 0; i < 3; ++i) c[i] = cen[i * Gp + g];
    for (int i = 0; i < 17; ++i) ax[i] = aux[i * Gp + g];
    float jv[6], D[36];
    rows_point(r, m, c, ax, rw, jv, D);
    if (JD) {
      for (int i = 0; i < 6; ++i) jd[i * kThreads + threadIdx.x] += jv[i];
      for (int i = 0; i < 36; ++i)
        jd[(6 + i) * kThreads + threadIdx.x] += D[i];
    }
  } else {
    for (int j = 0; j < 6; ++j)
      for (int k = 0; k < 3; ++k) rw[j][k] = 0.f;
  }
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 6; ++j)
      S[(3 * gl + k) * T::LD + j * BT + wl] = rw[j][k];
}

// acc += A B^T over one chunk.  Thread (ty, tx) owns rows 32 i + 2 ty + e
// and columns 32 i + 2 tx + e (e = 0, 1): float2 loads, conflict-free.
template <int BT>
__device__ __forceinline__ void chunk_product(
    const float* __restrict__ As, const float* __restrict__ Bs,
    float (&acc)[Tile<BT>::TM][Tile<BT>::TM]) {
  using T = Tile<BT>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 2
  for (int kk = 0; kk < T::KD; ++kk) {
    float a[T::TM], b[T::TM];
#pragma unroll
    for (int i = 0; i < T::TM / 2; ++i) {
      const float2 va =
          *reinterpret_cast<const float2*>(As + kk * T::LD + 32 * i + 2 * ty);
      const float2 vb =
          *reinterpret_cast<const float2*>(Bs + kk * T::LD + 32 * i + 2 * tx);
      a[2 * i] = va.x;
      a[2 * i + 1] = va.y;
      b[2 * i] = vb.x;
      b[2 * i + 1] = vb.y;
    }
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Calls out(r, c, value) for every entry of the thread's micro-tile, with
// r, c the tile-local (j * BT + scan) indices.
template <int BT, class Out>
__device__ __forceinline__ void store_tile(
    const float (&acc)[Tile<BT>::TM][Tile<BT>::TM], Out out) {
  using T = Tile<BT>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TM; ++j)
      out(32 * (i >> 1) + 2 * ty + (i & 1), 32 * (j >> 1) + 2 * tx + (j & 1),
          acc[i][j]);
}

// The common body: the (6 BT)^2 tile of the product over plane chunks
// [c0, c1) for row scans [wr0, wr0 + BT) and column scans [wc0, wc0 + BT),
// each side built only below its limit (wr_lim, wc_lim; zero rows past
// it).  same: the two sides are the same scans (rows built once, J and D
// summed into the slots).  The register tile is flushed into the block's
// own output entries every kFlushTerms product terms, out(r, c, v, first)
// storing v on the first flush and adding it after: a single fp32 running
// sum over all 3 Gp terms (34,560 at Gp = 11520) drops the terms below
// half an ulp of the sum and drifted 6.4e-5 of max|H| from the plain
// version; ~90 partial sums of 384 terms each, added in a fixed order,
// keep that error at the product's own rounding (PERF.md).
constexpr int kFlushTerms = 384;

template <int BT, class Out>
__device__ __forceinline__ void tile_accumulate(
    const float* __restrict__ pose, const float* __restrict__ mom,
    const float* __restrict__ cen, const float* __restrict__ aux,
    int64_t Gp, int64_t wr0, int64_t wr_lim, int64_t wc0, int64_t wc_lim,
    bool same, int64_t c0, int64_t c1, float* smem, Out out) {
  using T = Tile<BT>;
  constexpr int kFlushChunks = kFlushTerms / T::KD;
  float* As = smem;
  float* Bs = smem + T::KD * T::LD;
  float* jd = smem + 2 * T::KD * T::LD;
  const int gl = threadIdx.x % T::BK, wl = threadIdx.x / T::BK;
  float acc[T::TM][T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TM; ++j) acc[i][j] = 0.f;
  if (same)
    for (int i = 0; i < kJDc; ++i) jd[i * kThreads + threadIdx.x] = 0.f;
  bool first = true;
  int since = 0;
  for (int64_t ch = c0; ch < c1; ++ch) {
    const int64_t g = ch * T::BK + gl;
    const bool gl_live = g < Gp;
    __syncthreads();  // the previous chunk's product has read As, Bs
    if (same) {
      build_point<BT, true>(pose, mom, cen, aux, Gp, wr0 + wl,
                            gl_live && wr0 + wl < wr_lim, g, wl, gl, As, jd);
    } else {
      build_point<BT, false>(pose, mom, cen, aux, Gp, wr0 + wl,
                             gl_live && wr0 + wl < wr_lim, g, wl, gl, As,
                             nullptr);
      build_point<BT, false>(pose, mom, cen, aux, Gp, wc0 + wl,
                             gl_live && wc0 + wl < wc_lim, g, wl, gl, Bs,
                             nullptr);
    }
    __syncthreads();
    chunk_product<BT>(As, same ? As : Bs, acc);
    if (++since == kFlushChunks || ch + 1 == c1) {
      store_tile<BT>(acc, [&](int r, int c, float v) { out(r, c, v, first); });
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TM; ++j) acc[i][j] = 0.f;
      first = false;
      since = 0;
    }
  }
  if (first)  // an empty plane range: zeros
    store_tile<BT>(acc, [&](int r, int c, float v) { out(r, c, v, true); });
}

// Sums each scan's J/D slots over the threads that built its planes, in
// order, and calls out(scan, channel, value) for scans below n.
template <int BT, class Out>
__device__ __forceinline__ void store_jd(const float* smem, int n, Out out) {
  using T = Tile<BT>;
  const float* jd = smem + 2 * T::KD * T::LD;
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * kJDc; idx += kThreads) {
    const int a = idx / kJDc, ch = idx % kJDc;
    float s = 0.f;
    for (int gl = 0; gl < T::BK; ++gl) s += jd[ch * kThreads + a * T::BK + gl];
    out(a, ch, s);
  }
}

constexpr int kBT2 = 16;  // B4 tile
constexpr int kBT3 = 16;  // B5 sub-tile
constexpr int kBT1 = 32;  // B6 tile

// B4: grid (nT, nT), block (J tile, I tile); the whole plane axis.
__global__ void __launch_bounds__(kThreads, 2)
    hess_v2_kernel(const float* __restrict__ pose,
                   const float* __restrict__ mom,
                   const float* __restrict__ cen,
                   const float* __restrict__ aux, float* __restrict__ H,
                   float* __restrict__ J, float* __restrict__ D, int64_t Wp,
                   int64_t Gp) {
  constexpr int BT = kBT2;
  using T = Tile<BT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t wr0 = (int64_t)blockIdx.y * BT, wc0 = (int64_t)blockIdx.x * BT;
  const bool same = blockIdx.x == blockIdx.y;
  const int64_t n6 = 6 * Wp;
  tile_accumulate<BT>(
      pose, mom, cen, aux, Gp, wr0, Wp, wc0, Wp, same, 0, cdiv(Gp, T::BK),
      smem, [&](int r, int c, float v, bool first) {
        const int64_t w = wr0 + r % BT, w2 = wc0 + c % BT;
        if (w < Wp && w2 < Wp) {
          float* h = H + ((r / BT) * Wp + w) * n6 + (c / BT) * Wp + w2;
          *h = first ? v : *h + v;
        }
      });
  if (same) {
    const int n = (int)(Wp - wr0 < BT ? Wp - wr0 : BT);
    store_jd<BT>(smem, n, [&](int a, int ch, float v) {
      if (ch < 6) J[(wr0 + a) * 6 + ch] = v;
      else D[(wr0 + a) * 36 + ch - 6] = v;
    });
  }
}

// B5: grid (nsub^2, n_pairs); pair p = (I, J), I >= J, in the order
// (0,0), (1,0), (1,1), (2,0), ...; sub-tile (si, sj) of the pair block.
__global__ void __launch_bounds__(kThreads, 2)
    hess_v3_kernel(const float* __restrict__ pose,
                   const float* __restrict__ mom,
                   const float* __restrict__ cen,
                   const float* __restrict__ aux, float* __restrict__ Hblk,
                   float* __restrict__ J, float* __restrict__ D, int64_t Wp,
                   int64_t Gp, int64_t Bw) {
  constexpr int BT = kBT3;
  using T = Tile<BT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t p = blockIdx.y;
  int64_t I = 0;
  while ((I + 1) * (I + 2) / 2 <= p) ++I;
  const int64_t Jb = p - I * (I + 1) / 2;
  const int64_t nsub = cdiv(Bw, BT);
  const int64_t si = blockIdx.x / nsub, sj = blockIdx.x % nsub;
  const int64_t wr0 = I * Bw + si * BT, wc0 = Jb * Bw + sj * BT;
  const int64_t wr_lim = (I + 1) * Bw < Wp ? (I + 1) * Bw : Wp;
  const int64_t wc_lim = (Jb + 1) * Bw < Wp ? (Jb + 1) * Bw : Wp;
  const bool same = I == Jb && si == sj;
  // rows and columns of the tile inside the pair block (padding scans
  // past Wp but inside the last block are written as zeros)
  const int64_t nr = Bw - si * BT < BT ? Bw - si * BT : BT;
  const int64_t nc = Bw - sj * BT < BT ? Bw - sj * BT : BT;
  const int64_t n6 = 6 * Bw;
  float* Hp = Hblk + p * n6 * n6;
  tile_accumulate<BT>(
      pose, mom, cen, aux, Gp, wr0, wr_lim, wc0, wc_lim, same, 0,
      cdiv(Gp, T::BK), smem, [&](int r, int c, float v, bool first) {
        const int a = r % BT, b = c % BT;
        if (a < nr && b < nc) {
          float* h = Hp + ((r / BT) * Bw + si * BT + a) * n6 + (c / BT) * Bw +
                     sj * BT + b;
          *h = first ? v : *h + v;
        }
      });
  if (same) {
    store_jd<BT>(smem, (int)nr, [&](int a, int ch, float v) {
      if (ch < 6) J[(wr0 + a) * 6 + ch] = v;
      else D[(wr0 + a) * 36 + ch - 6] = v;
    });
  }
}

// B6: grid (nT * nT, nsplit); partial Htilde and J/D of plane split s.
__global__ void __launch_bounds__(kThreads, 1)
    hess_v1_kernel(const float* __restrict__ pose,
                   const float* __restrict__ mom,
                   const float* __restrict__ cen,
                   const float* __restrict__ aux, float* __restrict__ Hpart,
                   float* __restrict__ JDpart, int64_t Wp, int64_t Gp) {
  constexpr int BT = kBT1;
  using T = Tile<BT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t nT = cdiv(Wp, BT);
  const int64_t ti = blockIdx.x / nT, tj = blockIdx.x % nT;
  const int64_t s = blockIdx.y, nsplit = gridDim.y;
  const int64_t nchunk = cdiv(Gp, T::BK);
  const int64_t wr0 = ti * BT, wc0 = tj * BT;
  const bool same = ti == tj;
  const int64_t n6 = 6 * Wp;
  float* H = Hpart + s * n6 * n6;
  tile_accumulate<BT>(
      pose, mom, cen, aux, Gp, wr0, Wp, wc0, Wp, same, s * nchunk / nsplit,
      (s + 1) * nchunk / nsplit, smem, [&](int r, int c, float v, bool first) {
        const int64_t w = wr0 + r % BT, w2 = wc0 + c % BT;
        if (w < Wp && w2 < Wp) {
          float* h = H + ((r / BT) * Wp + w) * n6 + (c / BT) * Wp + w2;
          *h = first ? v : *h + v;
        }
      });
  if (same) {
    const int n = (int)(Wp - wr0 < BT ? Wp - wr0 : BT);
    float* JD = JDpart + s * Wp * kJDc;
    store_jd<BT>(smem, n, [&](int a, int ch, float v) {
      JD[(wr0 + a) * kJDc + ch] = v;
    });
  }
}

// B6's second pass: H = sum over splits of the partials, in split order;
// J (Wp, 6) and D (Wp, 36) likewise from the (nsplit, Wp, 42) partials.
__global__ void hess_v1_sum_kernel(const float* __restrict__ Hpart,
                                   const float* __restrict__ JDpart,
                                   float* __restrict__ H,
                                   float* __restrict__ J,
                                   float* __restrict__ D, int64_t Wp,
                                   int64_t nsplit) {
  const int64_t nh = 36 * Wp * Wp, njd = Wp * kJDc;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < nh + njd; i += stride) {
    if (i < nh) {
      float acc = 0.f;
      for (int64_t s = 0; s < nsplit; ++s) acc += Hpart[s * nh + i];
      H[i] = acc;
    } else {
      const int64_t q = i - nh, w = q / kJDc;
      const int ch = (int)(q % kJDc);
      float acc = 0.f;
      for (int64_t s = 0; s < nsplit; ++s) acc += JDpart[s * njd + q];
      if (ch < 6) J[w * 6 + ch] = acc;
      else D[w * 36 + ch - 6] = acc;
    }
  }
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// As in packed_kernels.cu: each launcher selects the device, enqueues on
// the given stream, does not synchronise, and returns cudaGetLastError().

// Plane splits of B6 at this shape: enough (tile, split) blocks for two
// per SM, at most one split per plane chunk.
extern "C" int balm_hess_v1_splits(int64_t Wp, int64_t Gp, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  const int64_t nT = cdiv(Wp, kBT1);
  const int64_t nchunk = cdiv(Gp, Tile<kBT1>::BK);
  int64_t s = cdiv(2 * (int64_t)sms, nT * nT);
  if (s > nchunk) s = nchunk;
  return (int)(s < 1 ? 1 : s);
}

extern "C" int balm_hess_v2(const float* pose, const float* mom,
                            const float* cen, const float* aux, float* H,
                            float* J, float* D, int64_t Wp, int64_t Gp,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = Tile<kBT2>::kSmemFloats * (int)sizeof(float);
  err = allow_smem(hess_v2_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned nT = (unsigned)cdiv(Wp, kBT2);
  hess_v2_kernel<<<dim3(nT, nT), kThreads, bytes, (cudaStream_t)stream>>>(
      pose, mom, cen, aux, H, J, D, Wp, Gp);
  return (int)cudaGetLastError();
}

extern "C" int balm_hess_v3(const float* pose, const float* mom,
                            const float* cen, const float* aux, float* Hblk,
                            float* J, float* D, int64_t Wp, int64_t Gp,
                            int64_t Bw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = Tile<kBT3>::kSmemFloats * (int)sizeof(float);
  err = allow_smem(hess_v3_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t nB = cdiv(Wp, Bw), nsub = cdiv(Bw, kBT3);
  const dim3 grid((unsigned)(nsub * nsub), (unsigned)(nB * (nB + 1) / 2));
  hess_v3_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      pose, mom, cen, aux, Hblk, J, D, Wp, Gp, Bw);
  return (int)cudaGetLastError();
}

extern "C" int balm_hess_v1(const float* pose, const float* mom,
                            const float* cen, const float* aux, float* Hpart,
                            float* JDpart, float* H, float* J, float* D,
                            int64_t Wp, int64_t Gp, int64_t nsplit,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes = Tile<kBT1>::kSmemFloats * (int)sizeof(float);
  err = allow_smem(hess_v1_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t nT = cdiv(Wp, kBT1);
  hess_v1_kernel<<<dim3((unsigned)(nT * nT), (unsigned)nsplit), kThreads,
                   bytes, (cudaStream_t)stream>>>(pose, mom, cen, aux, Hpart,
                                                  JDpart, Wp, Gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = 36 * Wp * Wp + Wp * kJDc;
  const int64_t blocks = cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096;
  hess_v1_sum_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      Hpart, JDpart, H, J, D, Wp, nsplit);
  return (int)cudaGetLastError();
}
