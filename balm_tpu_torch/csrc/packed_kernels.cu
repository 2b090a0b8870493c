// CUDA C++ kernels of the packed plane-factor evaluate, for sm_90a.
//
// Both kernels read the packed layout of balm_tpu_torch/ops/packed.py:
//   pose (Wp, 12)      row-major [R (9) | t (3)] per scan
//   mom  (Wp, 10, Gp)  per-(scan, plane) channels vech(P) (6), b (3), n
//   cen  (3, Gp)       world conditioning centers
//   cfix (10, Gp)      fixed moment channels vech(P) (6), b (3), n
//   aux  (17, Gp)      u0 u1 u2 (9), vbar (3), 1/N, sqrt weights (3), coe
// with the plane axis contiguous, so one thread per plane reads every
// channel coalesced.  Shapes may be ragged (any Wp >= 1, Gp >= 1).
//
// B1 `csum` replaces the Pallas `_csum_kernel` (balm_tpu/ops/
// pallas_evaluate.py:115, wrapper csum_packed :180).  Two-pass centered
// world plane moments: pass 1 forms vbar = (sum_w n t + n_f b_f) / N, pass
// 2 accumulates R P R^T + n (t - vbar)(t - vbar)^T directly.  The one-pass
// sum(n t t^T) - N vbar vbar^T form is never used: it cancels the f32
// mantissa on far-from-origin scenes.  Bound on the H100: bytes (mom read
// once dominates, ~10*4 B per (scan, plane) against ~150 flops).  Design:
// a block is 32 planes (one warp, coalesced along g) x 8 scan lanes, so a
// 5k-plane problem puts ~1.3k warps in flight; pose rows are staged in
// shared memory in 256-scan chunks; the 8 scan-lane partial sums are
// combined in a fixed order in shared memory (deterministic).  Pass 2
// re-reads mom (the second read mostly hits L2: a block's slice of mom is
// ~1.3 MB at Wp = 256).
//
// B2 `rows` replaces the Pallas `_rows_only_kernel` (pallas_evaluate.py
// :1126, wrapper rows_packed_pallas :1155; same math as
// _rows_channels_xla :789).  Per (scan, plane): three rank rows of 6
// (sqa a, sqk1 g1, sqk2 g2) written (3, 6, Wp, Gp) coalesced along g, and
// the gradient (6) and block-diagonal correction (36) summed over planes
// into J (Wp, 6) and D (Wp, 36).  Bound: bytes (reads mom once, writes 18
// floats per (scan, plane)).  Design: one thread per (scan, plane), 128
// planes per block; J/D are reduced per block by warp shuffles and shared
// memory into a partial buffer, then a second small kernel sums the
// partials over plane tiles in a fixed order — no atomics, so two runs
// give bit-identical J, D and hence the same LM trajectory.
//
// Batched launches (balm_*_packed_batched): B problems of one shape
// stacked on a leading axis, pose (B, Wp, 12), mom (B, Wp, 10, Gp), cen
// (B, 3, Gp), cfix (B, 10, Gp), aux (B, 17, Gp) -> out (B, 10, Gp), rows
// (B, 3, 6, Wp, Gp), J (B, Wp, 6), D (B, Wp, 36).  The problem index is a
// grid dimension (csum: y, rows: z) and each block offsets its pointers
// by it; the single-problem launches are B = 1, so both run one body.
// They stand for the JAX package's jax.vmap of the two pallas_calls in
// the device-batched hierarchy (balm_tpu/pipelines/hierarchical.py
// :711-713), which gives each a batch grid axis.  At the hierarchy's
// blocks (Wp = 16, Gp = 256) one problem fills 8 csum and 32 rows
// blocks; the batch of B = 255 fills the card, one launch per evaluate.
//
// The per-element math (rows_point and its helpers) lives in
// rows_point.cuh, shared with hess_kernels.cu (B4, B5, B6).
//
// Build (plain C interface, loaded with ctypes by ops/_cuda.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libbalm_kernels.so \
//        packed_kernels.cu hess_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows_point.cuh"

namespace {

constexpr int kCsumBG = 32;      // planes per csum block (x)
constexpr int kCsumBW = 8;       // scan lanes per csum block (y)
constexpr int kPoseChunk = 256;  // scans of pose staged in shared memory
constexpr int kRowsBG = 128;     // planes per rows block
constexpr int kJD = 42;          // J (6) + D (36) channels per scan

// ---- kernels -------------------------------------------------------------

__global__ void __launch_bounds__(kCsumBG * kCsumBW)
    csum_kernel(const float* __restrict__ pose, const float* __restrict__ mom,
                const float* __restrict__ cen, const float* __restrict__ cfix,
                float* __restrict__ out, int64_t Wp, int64_t Gp) {
  __shared__ float sp[kPoseChunk * 12];
  __shared__ float red[kCsumBW][6][kCsumBG];
  __shared__ float vbs[3][kCsumBG];
  // problem blockIdx.y of a batch of equal-shape problems (1 alone)
  const int64_t bz = blockIdx.y;
  pose += bz * Wp * 12;
  mom += bz * Wp * 10 * Gp;
  cen += bz * 3 * Gp;
  cfix += bz * 10 * Gp;
  out += bz * 10 * Gp;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCsumBG + tx;
  const int nthreads = kCsumBG * kCsumBW;
  const int64_t g = (int64_t)blockIdx.x * kCsumBG + tx;
  const bool live = g < Gp;
  float c[3] = {0.f, 0.f, 0.f};
  if (live) {
    c[0] = cen[g];
    c[1] = cen[Gp + g];
    c[2] = cen[2 * Gp + g];
  }

  // pass 1: vsum = sum_w n t, N = sum_w n
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t w0 = 0; w0 < Wp; w0 += kPoseChunk) {
    const int nw = (int)((Wp - w0) < kPoseChunk ? (Wp - w0) : kPoseChunk);
    __syncthreads();
    for (int i = tid; i < nw * 12; i += nthreads) sp[i] = pose[w0 * 12 + i];
    __syncthreads();
    if (live) {
      for (int wl = ty; wl < nw; wl += kCsumBW) {
        const float* m = mom + (w0 + wl) * 10 * Gp + g;
        const float b[3] = {m[6 * Gp], m[7 * Gp], m[8 * Gp]};
        const float n = m[9 * Gp];
        float t[3];
        shifted_t(sp + wl * 12, b, c, t);
        s[0] += n * t[0];
        s[1] += n * t[1];
        s[2] += n * t[2];
        s[3] += n;
      }
    }
  }
  for (int k = 0; k < 4; ++k) red[ty][k][tx] = s[k];
  __syncthreads();
  if (ty == 0) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int yy = 0; yy < kCsumBW; ++yy)
      for (int k = 0; k < 4; ++k) acc[k] += red[yy][k][tx];
    if (live) {
      const float nf = cfix[9 * Gp + g];
      const float N = acc[3] + nf;
      const float Ns = N > 0.5f ? N : 1.0f;
      for (int k = 0; k < 3; ++k) {
        const float vsum = acc[k] + nf * cfix[(6 + k) * Gp + g];
        vbs[k][tx] = vsum / Ns;
        out[(6 + k) * Gp + g] = vsum;
      }
      out[9 * Gp + g] = N;
    } else {
      for (int k = 0; k < 3; ++k) vbs[k][tx] = 0.f;
    }
  }
  __syncthreads();
  const float vbar[3] = {vbs[0][tx], vbs[1][tx], vbs[2][tx]};

  // pass 2: sum_w R P R^T + n (t - vbar)(t - vbar)^T
  float q[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int64_t w0 = 0; w0 < Wp; w0 += kPoseChunk) {
    const int nw = (int)((Wp - w0) < kPoseChunk ? (Wp - w0) : kPoseChunk);
    __syncthreads();
    for (int i = tid; i < nw * 12; i += nthreads) sp[i] = pose[w0 * 12 + i];
    __syncthreads();
    if (live) {
      for (int wl = ty; wl < nw; wl += kCsumBW) {
        const float* r = sp + wl * 12;
        const float* m = mom + (w0 + wl) * 10 * Gp + g;
        const float pch[6] = {m[0], m[Gp], m[2 * Gp],
                              m[3 * Gp], m[4 * Gp], m[5 * Gp]};
        const float b[3] = {m[6 * Gp], m[7 * Gp], m[8 * Gp]};
        const float n = m[9 * Gp];
        float t[3], M[3][3];
        shifted_t(r, b, c, t);
        rprt(r, pch, M);
        const float d[3] = {t[0] - vbar[0], t[1] - vbar[1], t[2] - vbar[2]};
        const float nd[3] = {n * d[0], n * d[1], n * d[2]};
        q[0] += M[0][0] + nd[0] * d[0];
        q[1] += M[0][1] + nd[0] * d[1];
        q[2] += M[0][2] + nd[0] * d[2];
        q[3] += M[1][1] + nd[1] * d[1];
        q[4] += M[1][2] + nd[1] * d[2];
        q[5] += M[2][2] + nd[2] * d[2];
      }
    }
  }
  __syncthreads();
  for (int k = 0; k < 6; ++k) red[ty][k][tx] = q[k];
  __syncthreads();
  if (ty == 0 && live) {
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int yy = 0; yy < kCsumBW; ++yy)
      for (int k = 0; k < 6; ++k) acc[k] += red[yy][k][tx];
    const float nf = cfix[9 * Gp + g];
    const float fixq = nf > 0.5f ? nf : 0.0f;
    float df[3];
    for (int k = 0; k < 3; ++k) df[k] = cfix[(6 + k) * Gp + g] - vbar[k];
    const int ii[6] = {0, 0, 0, 1, 1, 2};
    const int jj[6] = {0, 1, 2, 1, 2, 2};
    for (int k = 0; k < 6; ++k)
      out[k * Gp + g] = acc[k] + cfix[k * Gp + g] + fixq * df[ii[k]] * df[jj[k]];
  }
}

__global__ void __launch_bounds__(kRowsBG)
    rows_kernel(const float* __restrict__ pose, const float* __restrict__ mom,
                const float* __restrict__ cen, const float* __restrict__ aux,
                float* __restrict__ rows, float* __restrict__ partial,
                int64_t Wp, int64_t Gp) {
  __shared__ float wsum[kRowsBG / 32][kJD];
  // problem blockIdx.z of a batch of equal-shape problems (1 alone)
  const int64_t bz = blockIdx.z;
  pose += bz * Wp * 12;
  mom += bz * Wp * 10 * Gp;
  cen += bz * 3 * Gp;
  aux += bz * 17 * Gp;
  rows += bz * 18 * Wp * Gp;
  partial += bz * Wp * gridDim.x * kJD;
  const int64_t w = blockIdx.y;
  const int64_t g = (int64_t)blockIdx.x * kRowsBG + threadIdx.x;
  const bool live = g < Gp;
  float jv[6], D[36];
  if (live) {
    float r[12], m[10], c[3], ax[17];
    for (int i = 0; i < 12; ++i) r[i] = pose[w * 12 + i];
    for (int i = 0; i < 10; ++i) m[i] = mom[(w * 10 + i) * Gp + g];
    for (int i = 0; i < 3; ++i) c[i] = cen[i * Gp + g];
    for (int i = 0; i < 17; ++i) ax[i] = aux[i * Gp + g];
    float rw[6][3];
    rows_point(r, m, c, ax, rw, jv, D);
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 6; ++j)
        rows[((k * 6 + j) * Wp + w) * Gp + g] = rw[j][k];
  } else {
    for (int i = 0; i < 6; ++i) jv[i] = 0.f;
    for (int i = 0; i < 36; ++i) D[i] = 0.f;
  }
  // block reduction of the 42 J/D channels over the block's planes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kJD; ++i) {
    float v = i < 6 ? jv[i] : D[i - 6];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) wsum[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kJD) {
    float acc = 0.f;
    for (int k = 0; k < kRowsBG / 32; ++k) acc += wsum[k][threadIdx.x];
    partial[(w * gridDim.x + blockIdx.x) * kJD + threadIdx.x] = acc;
  }
}

// J (Wp, 6), D (Wp, 36) = sum over plane tiles of the partials, in order
// (a batch's J and D are (B * Wp, ...) with Wp = B * Wp here).
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ J,
                                       float* __restrict__ D, int64_t Wp,
                                       int64_t ntiles) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Wp * kJD) return;
  const int64_t w = i / kJD;
  const int ch = (int)(i % kJD);
  float acc = 0.f;
  for (int64_t t = 0; t < ntiles; ++t) acc += partial[(w * ntiles + t) * kJD + ch];
  if (ch < 6)
    J[w * 6 + ch] = acc;
  else
    D[w * 36 + ch - 6] = acc;
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Each launcher selects the tensors' device in this library's runtime,
// enqueues on the given stream (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int balm_rows_block_planes() { return kRowsBG; }

extern "C" const char* balm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int balm_csum_packed_batched(const float* pose, const float* mom,
                                        const float* cen, const float* cfix,
                                        float* out, int64_t B, int64_t Wp,
                                        int64_t Gp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kCsumBG, kCsumBW);
  const dim3 grid((unsigned)((Gp + kCsumBG - 1) / kCsumBG), (unsigned)B);
  csum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(pose, mom, cen, cfix,
                                                         out, Wp, Gp);
  return (int)cudaGetLastError();
}

extern "C" int balm_csum_packed(const float* pose, const float* mom,
                                const float* cen, const float* cfix,
                                float* out, int64_t Wp, int64_t Gp,
                                int device, void* stream) {
  return balm_csum_packed_batched(pose, mom, cen, cfix, out, 1, Wp, Gp,
                                  device, stream);
}

extern "C" int balm_rows_packed_batched(const float* pose, const float* mom,
                                        const float* cen, const float* aux,
                                        float* rows, float* partial, float* J,
                                        float* D, int64_t B, int64_t Wp,
                                        int64_t Gp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t ntiles = (Gp + kRowsBG - 1) / kRowsBG;
  const dim3 grid((unsigned)ntiles, (unsigned)Wp, (unsigned)B);
  rows_kernel<<<grid, kRowsBG, 0, (cudaStream_t)stream>>>(
      pose, mom, cen, aux, rows, partial, Wp, Gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = B * Wp * kJD;
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                           (cudaStream_t)stream>>>(partial, J, D, B * Wp,
                                                   ntiles);
  return (int)cudaGetLastError();
}

extern "C" int balm_rows_packed(const float* pose, const float* mom,
                                const float* cen, const float* aux,
                                float* rows, float* partial, float* J,
                                float* D, int64_t Wp, int64_t Gp,
                                int device, void* stream) {
  return balm_rows_packed_batched(pose, mom, cen, aux, rows, partial, J, D, 1,
                                  Wp, Gp, device, stream);
}
