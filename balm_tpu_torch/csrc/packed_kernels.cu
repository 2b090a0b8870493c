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
// Both kernels rely on the layout's invariant (ops/packed.py): an entry
// with n == 0 has P == 0, and its b is finite.  Such an entry adds
// exactly +-0 to every output (n t, R P R^T + n d d^T, the rank rows, J
// and D), so the kernels read n first and skip it: no byte of an empty
// entry's other nine channels is fetched.  On a voxelized scene a plane
// is seen from a few of the scans (about 2% of the entries live on the
// 256-scan scene of chip_smoke.py), so what the kernels must read is n
// once and the live entries' other channels.
//
// B1 `csum` replaces the Pallas `_csum_kernel` (balm_tpu/ops/
// pallas_evaluate.py:115, wrapper csum_packed :180).  Two-pass centered
// world plane moments: pass 1 forms vbar = (sum_w n t + n_f b_f) / N, pass
// 2 accumulates R P R^T + n (t - vbar)(t - vbar)^T directly.  The one-pass
// sum(n t t^T) - N vbar vbar^T form is never used: it cancels the f32
// mantissa on far-from-origin scenes.  Bound on the H100: bytes (n of
// every entry, the live entries' nine other channels; ~165 flops per live
// entry).  Design: a block is 32 planes (one warp, coalesced along g) x 8
// scan lanes; lane ty sums the scans w = ty (mod 8) in ascending order
// and the 8 lane sums are merged in a fixed order in shared memory, the
// order of the earlier dense kernel, so dropping the +-0 terms of empty
// entries leaves the outputs value-equal to it.  Per chunk of 256 scans
// each thread stages the n of its 32 scans (cp.async, all in flight,
// beside the chunk's pose rows) into a 32-bit live mask; the warp's OR of
// the masks lists the scans any of its planes is seen from.  When those
// are at most kStage (the usual case on a scene: about 1 of 32 on the
// 256-scan scene), their entries are staged whole in one batch, each live
// lane copying only its own entry, and both passes read them from shared
// memory: mom is read from device memory once, and only where n != 0.
// Otherwise (a dense warp) each pass runs every scan of the lane, as the
// dense kernel did, but an empty entry's lane loads zeros from kZero
// instead of its channels.  At Wp <= 32 (csum_kernel<true>, the
// hierarchy's blocks) every warp's live scans fit the stage, and the
// kernel needs fewer registers.
//
// B2 `rows` replaces the Pallas `_rows_only_kernel` (pallas_evaluate.py
// :1126, wrapper rows_packed_pallas :1155; same math as
// _rows_channels_xla :789).  Per (scan, plane): three rank rows of 6
// (sqa a, sqk1 g1, sqk2 g2) written (3, 6, Wp, Gp) coalesced along g, and
// the gradient (6) and block-diagonal correction (36) summed over planes
// into J (Wp, 6) and D (Wp, 36).  Bound: bytes (n once, the live entries'
// other channels, the dense rows written once: the rows stay dense, as
// the JAX function returns them).  Design: one thread per (scan, plane),
// 128 planes per block.  Each thread reads n first; a warp none of whose
// 32 planes is seen from the block's scan stores its 18 zero rows
// (coalesced) and zero J/D partials, and skips rows_point and the
// reduction.  In a live warp every lane runs rows_point, an empty entry's
// lane on zeros loaded from kZero.  J/D are reduced per block by warp
// shuffles and shared memory into a partial buffer, then a second small
// kernel sums the partials over plane tiles in a fixed order — no atomics,
// so two runs give bit-identical J, D and hence the same LM trajectory.
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

constexpr int kCsumBG = 32;                 // planes per csum block (x)
constexpr int kCsumBW = 8;                  // scan lanes per csum block (y)
constexpr int kCsumT = kCsumBG * kCsumBW;   // threads per csum block
constexpr int kCsumJ = 32;                  // scans per lane per chunk
constexpr int kChunk = kCsumBW * kCsumJ;    // scans per chunk (256)
constexpr int kStage = 4;                   // scans staged whole, at most
constexpr int kMomCh = 10;                  // channels of mom
constexpr int kRowsBG = 128;                // planes per rows block
// blocks a SM holds: bounds each kernel's registers (80 for rows, 85 for
// csum, 51 for csum at small Wp: none spills)
constexpr int kRowsMinBlocks = 6;
constexpr int kCsumMinBlocks = 3;
constexpr int kCsumSmallMinBlocks = 5;
constexpr int kJD = 42;                     // J (6) + D (36) channels per scan
constexpr unsigned kFull = 0xffffffffu;
// what an empty entry's lane loads instead of its channels
__device__ const float kZero[kMomCh] = {};

// ---- staging -------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// wait for this thread's cp.async copies (each thread reads back only
// its own slots, so no barrier is needed)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bit j: n != 0 at scan j of this lane's nj scans, n0 the first one's n,
// `step` floats apart.  The n are staged (cp.async, all in flight) in
// rows 0 .. nj - 1 of this thread's slots `st`.
__device__ __forceinline__ uint32_t lane_mask(float* st, const float* n0,
                                              int64_t step, int nj) {
  for (int j = 0; j < nj; ++j) cp_async4(st + j * kCsumT, n0 + j * step);
  cp_async_wait_all();
  uint32_t m = 0;
  for (int j = 0; j < nj; ++j) m |= (st[j * kCsumT] != 0.f ? 1u : 0u) << j;
  return m;
}

// Copy the channels of this lane's live entries among the scans of
// `batch` (bit j: scan j, m0 + j * step its entry) into slot s of `st`
// (the s-th bit of the batch, kMomCh rows of kCsumT floats), then wait
// for them.
__device__ __forceinline__ void stage_batch(float* st, const float* m0,
                                            int64_t step, int64_t Gp,
                                            uint32_t batch, uint32_t lm) {
  int s = 0;
  for (uint32_t b = batch; b; b &= b - 1, ++s) {
    const int j = __ffs(b) - 1;
    if (lm >> j & 1) {
      const float* m = m0 + j * step;
      float* d = st + s * kMomCh * kCsumT;
      for (int ch = 0; ch < kMomCh; ++ch)
        cp_async4(d + ch * kCsumT, m + ch * Gp);
    }
  }
  cp_async_wait_all();
}

// ---- kernels -------------------------------------------------------------

// dynamic shared memory: `cap` floats a thread, in rows of kCsumT.  They
// stage the lane's n, then, when the warp's live scans of its one chunk
// are at most cap / kMomCh, their entries whole, kept for pass 2.  kSmall
// (at most kStage scans a lane, Wp <= 32): that is always so.  Otherwise
// each pass runs every scan of the lane, as the dense kernel did, only
// live lanes loading (an empty entry enters as zeros and adds +-0), n from
// the stage.
template <bool kSmall>
__global__ void __launch_bounds__(kCsumT, kSmall ? kCsumSmallMinBlocks
                                                 : kCsumMinBlocks)
    csum_kernel(const float* __restrict__ pose, const float* __restrict__ mom,
                const float* __restrict__ cen, const float* __restrict__ cfix,
                float* __restrict__ out, int64_t Wp, int64_t Gp, int cap) {
  extern __shared__ float stage[];
  __shared__ float red[kCsumBW][6][kCsumBG];
  __shared__ float vbs[3][kCsumBG];
  __shared__ float cfs[kMomCh][kCsumBG];
  __shared__ float sp[(kSmall ? kCsumBW * kStage : kChunk) * 12];
  // problem blockIdx.y of a batch of equal-shape problems (1 alone)
  const int64_t bz = blockIdx.y;
  pose += bz * Wp * 12;
  mom += bz * Wp * kMomCh * Gp;
  cen += bz * 3 * Gp;
  cfix += bz * kMomCh * Gp;
  out += bz * kMomCh * Gp;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCsumBG + tx;
  const int64_t g = (int64_t)blockIdx.x * kCsumBG + tx;
  const bool live = g < Gp;
  float c[3] = {0.f, 0.f, 0.f};
  if (live) {
    c[0] = cen[g];
    c[1] = cen[Gp + g];
    c[2] = cen[2 * Gp + g];
    if (ty == 0)  // the fixed moments, for the merges
      for (int k = 0; k < kMomCh; ++k)
        cp_async4(&cfs[k][tx], cfix + k * Gp + g);
  }
  // lane ty's scans of a chunk are w0 + ty + kCsumBW j, j < nj
  const int64_t step = (int64_t)kCsumBW * kMomCh * Gp;
  const bool one_chunk = Wp <= kChunk;
  const int whole_n = cap / kMomCh;
  float* st = stage + tid;
  // a chunk's first entry and scan count of this lane, its pose rows
  // staged in sp (after a barrier: the previous chunk's are read by all)
  auto chunk = [&](int64_t w0, const float** m0, int* nj) {
    const int64_t nw = (Wp - w0) < kChunk ? (Wp - w0) : kChunk;
    *nj = (live && ty < nw) ? (int)((nw - ty + kCsumBW - 1) / kCsumBW) : 0;
    *m0 = mom + (w0 + ty) * kMomCh * Gp + g;
    if (w0 > 0) __syncthreads();
    for (int i = tid; i < nw * 12; i += kCsumT)
      cp_async4(sp + i, pose + w0 * 12 + i);
  };

  // pass 1: vsum = sum_w n t, N = sum_w n
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t lm1 = 0;     // the one chunk's live mask, kept for pass 2
  bool kept = false;    // ... and its entries, staged whole
  for (int64_t w0 = 0; w0 < Wp; w0 += kChunk) {
    const float* m0;
    int nj;
    chunk(w0, &m0, &nj);
    const uint32_t lm = lane_mask(st, m0 + 9 * Gp, step, nj);
    __syncthreads();  // sp
    const uint32_t um = __reduce_or_sync(kFull, lm);
    const bool whole = kSmall || (one_chunk && __popc(um) <= whole_n);
    if (whole) {
      stage_batch(st, m0, step, Gp, um, lm);
      int sl = 0;
      for (uint32_t b = um; b; b &= b - 1, ++sl) {
        const int j = __ffs(b) - 1;
        if (!(lm >> j & 1)) continue;
        const float* e = st + sl * kMomCh * kCsumT;
        const float bb[3] = {e[6 * kCsumT], e[7 * kCsumT], e[8 * kCsumT]};
        const float n = e[9 * kCsumT];
        float t[3];
        shifted_t(sp + (ty + kCsumBW * j) * 12, bb, c, t);
        s[0] += n * t[0];
        s[1] += n * t[1];
        s[2] += n * t[2];
        s[3] += n;
      }
    } else if (!kSmall) {
      // every scan of the lane in order, only live lanes loading; an
      // empty entry enters as zeros and adds +-0 (n from the stage)
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const bool on = lm >> j & 1;
        const float* m = on ? m0 + j * step + 6 * Gp : kZero;
        const int64_t gs = on ? Gp : 1;
        const float bb[3] = {m[0], m[gs], m[2 * gs]};
        const float n = st[j * kCsumT];
        float t[3];
        shifted_t(sp + (ty + kCsumBW * j) * 12, bb, c, t);
        s[0] += n * t[0];
        s[1] += n * t[1];
        s[2] += n * t[2];
        s[3] += n;
      }
    }
    lm1 = lm;
    kept = whole;
  }
  cp_async_wait_all();  // cfs
  for (int k = 0; k < 4; ++k) red[ty][k][tx] = s[k];
  __syncthreads();
  if (ty == 0) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int yy = 0; yy < kCsumBW; ++yy)
      for (int k = 0; k < 4; ++k) acc[k] += red[yy][k][tx];
    if (live) {
      const float nf = cfs[9][tx];
      const float N = acc[3] + nf;
      const float Ns = N > 0.5f ? N : 1.0f;
      for (int k = 0; k < 3; ++k) {
        const float vsum = acc[k] + nf * cfs[6 + k][tx];
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
  auto add = [&](const float* r, const float* pch, const float* bb,
                 float n) {
    float t[3], M[3][3];
    shifted_t(r, bb, c, t);
    rprt(r, pch, M);
    const float d[3] = {t[0] - vbar[0], t[1] - vbar[1], t[2] - vbar[2]};
    const float nd[3] = {n * d[0], n * d[1], n * d[2]};
    q[0] += M[0][0] + nd[0] * d[0];
    q[1] += M[0][1] + nd[0] * d[1];
    q[2] += M[0][2] + nd[0] * d[2];
    q[3] += M[1][1] + nd[1] * d[1];
    q[4] += M[1][2] + nd[1] * d[2];
    q[5] += M[2][2] + nd[2] * d[2];
  };
  for (int64_t w0 = 0; w0 < Wp; w0 += kChunk) {
    const float* m0;
    int nj;
    uint32_t lm = lm1;  // one chunk: its poses are still staged
    if (!one_chunk) {
      chunk(w0, &m0, &nj);
      lm = lane_mask(st, m0 + 9 * Gp, step, nj);
      __syncthreads();  // sp
    } else {
      m0 = mom + ty * kMomCh * Gp + g;
      nj = (live && ty < Wp) ? (int)((Wp - ty + kCsumBW - 1) / kCsumBW) : 0;
    }
    const uint32_t um = __reduce_or_sync(kFull, lm);
    if (kept) {
      int sl = 0;
      for (uint32_t b = um; b; b &= b - 1, ++sl) {
        const int j = __ffs(b) - 1;
        if (!(lm >> j & 1)) continue;
        const float* e = st + sl * kMomCh * kCsumT;
        const float pch[6] = {e[0],          e[kCsumT],     e[2 * kCsumT],
                              e[3 * kCsumT], e[4 * kCsumT], e[5 * kCsumT]};
        const float bb[3] = {e[6 * kCsumT], e[7 * kCsumT], e[8 * kCsumT]};
        add(sp + (ty + kCsumBW * j) * 12, pch, bb, e[9 * kCsumT]);
      }
    } else if (!kSmall) {
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const bool on = lm >> j & 1;
        float v[kMomCh - 1];
        const float* m = on ? m0 + j * step : kZero;
        const int64_t gs = on ? Gp : 1;
        for (int k = 0; k < kMomCh - 1; ++k) v[k] = m[k * gs];
        add(sp + (ty + kCsumBW * j) * 12, v, v + 6, st[j * kCsumT]);
      }
    }
  }
  for (int k = 0; k < 6; ++k) red[ty][k][tx] = q[k];
  __syncthreads();
  if (ty == 0 && live) {
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int yy = 0; yy < kCsumBW; ++yy)
      for (int k = 0; k < 6; ++k) acc[k] += red[yy][k][tx];
    const float nf = cfs[9][tx];
    const float fixq = nf > 0.5f ? nf : 0.0f;
    float df[3];
    for (int k = 0; k < 3; ++k) df[k] = cfs[6 + k][tx] - vbar[k];
    const int ii[6] = {0, 0, 0, 1, 1, 2};
    const int jj[6] = {0, 1, 2, 1, 2, 2};
    for (int k = 0; k < 6; ++k)
      out[k * Gp + g] = acc[k] + cfs[k][tx] + fixq * df[ii[k]] * df[jj[k]];
  }
}

// One thread a (scan, plane), kRowsBG planes a block.  n first: a warp
// none of whose planes is seen from the block's scan stores its zero rows
// and zero J/D.  In a live warp every lane runs rows_point, an empty
// entry's on zeros loaded from kZero (exactly +-0 out): only live lanes
// load their entry's channels.
__global__ void __launch_bounds__(kRowsBG, kRowsMinBlocks)
    rows_kernel(const float* __restrict__ pose, const float* __restrict__ mom,
                const float* __restrict__ cen, const float* __restrict__ aux,
                float* __restrict__ rows, float* __restrict__ partial,
                int64_t Wp, int64_t Gp) {
  __shared__ float wsum[kRowsBG / 32][kJD];
  // problem blockIdx.z of a batch of equal-shape problems (1 alone)
  const int64_t bz = blockIdx.z;
  pose += bz * Wp * 12;
  mom += bz * Wp * kMomCh * Gp;
  cen += bz * 3 * Gp;
  aux += bz * 17 * Gp;
  rows += bz * 18 * Wp * Gp;
  partial += bz * Wp * gridDim.x * kJD;
  const int64_t w = blockIdx.y;
  const int64_t g = (int64_t)blockIdx.x * kRowsBG + threadIdx.x;
  const bool inb = g < Gp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* m = mom + w * kMomCh * Gp + g;
  float* out = rows + w * Gp + g;  // rank row k, entry j at (k*6+j)*Wp*Gp
  const int64_t rs = Wp * Gp;
  const float n = inb ? m[9 * Gp] : 0.f;
  const bool live = n != 0.f;
  if (__ballot_sync(kFull, live) == 0) {
    if (inb)
      for (int i = 0; i < 18; ++i) out[i * rs] = 0.f;
    for (int i = lane; i < kJD; i += 32) wsum[warp][i] = 0.f;
  } else {
    float r[12], mm[kMomCh], c[3] = {0.f, 0.f, 0.f}, ax[17], rw[6][3];
    float jv[6], D[36];
    for (int i = 0; i < 12; ++i) r[i] = pose[w * 12 + i];
    const float* mp = live ? m : kZero;
    const int64_t gs = live ? Gp : 1;
    for (int i = 0; i < 9; ++i) mm[i] = mp[i * gs];
    mm[9] = n;
    for (int i = 0; i < 17; ++i) ax[i] = 0.f;
    if (inb) {
      for (int i = 0; i < 3; ++i) c[i] = cen[i * Gp + g];
      for (int i = 0; i < 17; ++i) ax[i] = aux[i * Gp + g];
    }
    rows_point(r, mm, c, ax, rw, jv, D);
    if (inb)
      for (int k = 0; k < 3; ++k)
        for (int j = 0; j < 6; ++j) out[(k * 6 + j) * rs] = rw[j][k];
    // warp reduction of the 42 J/D channels over the warp's planes
#pragma unroll
    for (int i = 0; i < kJD; ++i) {
      float v = i < 6 ? jv[i] : D[i - 6];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(kFull, v, off);
      if (lane == 0) wsum[warp][i] = v;
    }
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
  // a lane holds at most ceil(min(Wp, kChunk) / kCsumBW) scans a chunk
  const int64_t wc = Wp < kChunk ? Wp : kChunk;
  const int64_t per_lane = (wc + kCsumBW - 1) / kCsumBW;
  const int cap = (int)(per_lane < kStage ? per_lane : kStage) * kMomCh;
  const size_t smem = (size_t)cap * kCsumT * sizeof(float);
  // the stage and the static arrays pass 48 KB: allow it once per device
  static bool opted[64] = {};
  if (device < 64 && !opted[device]) {
    const int most = kStage * kMomCh * kCsumT * (int)sizeof(float);
    err = cudaFuncSetAttribute(csum_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(csum_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  const dim3 block(kCsumBG, kCsumBW);
  const dim3 grid((unsigned)((Gp + kCsumBG - 1) / kCsumBG), (unsigned)B);
  if (per_lane <= kStage)
    csum_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        pose, mom, cen, cfix, out, Wp, Gp, cap);
  else
    csum_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        pose, mom, cen, cfix, out, Wp, Gp, cap);
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
