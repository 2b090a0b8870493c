// CUDA C++ kernel B5 `hess_v3` of the fused-Hessian packed evaluate, for
// sm_90a.
//
// B5 replaces the Pallas `_hess_kernel_v3` (balm_tpu/ops/pallas_evaluate.py
// :604, wrapper hess_packed_v3 :697).  It computes the function of B4 and
// B6 (hess_kernels.cu) over the JAX kernel's grid of pose blocks: with
// Bw scans a block and nB = ceil(Wp / Bw) blocks, the raw pair blocks
//   H[I, J] = sum_k M_k[I] M_k[J]^T,   (6 Bw) x (6 Bw), I >= J,
// M_k[I] the rank rows of block I's scans, row j * Bw + w inside, in the
// pair order (0,0), (1,0), (1,1), (2,0), ..., and J (nB Bw, 6), D (nB Bw,
// 36), the sums over planes of the gradient and block-diagonal channels.
// Scans past Wp in the last block give zero rows.  The product is that of
// the split (as B4): bf16x3, hi hi^T + hi lo^T + lo hi^T (P = 2 pieces,
// the TPU kernel's default), or exact, six products of hi/mid/lo (P = 3).
//
// What bounds it on the H100: the tensor cores' operations, 0.25 ms
// (bf16x3) or 0.50 ms (exact) at Wp = 256, Gp = 11520, Bw = 128; next the
// bytes of the pieces that the product tiles read from L2 (2.8 GB and 4.1
// GB for the 78 tiles there, each piece read by every tile of its strip).
//
// Design, two stages (B4 and B6 build the rows inside the product kernel
// on one warpgroup, which then sets their pace):
//   * Stage 1, hess_v3_pieces_kernel: one pass over (scan, plane) with
//     rows_point, the device body of B2 and B4.  Each value is split into
//     its bf16 pieces (round to nearest even, JAX's astype) and written
//     straight into the layout that wgmma reads from shared memory: for
//     each (piece, pose block, plane chunk of 16 planes) one contiguous
//     block of RP x 48 bf16 (RP = 6 Bw rounded up to the 128-row tile),
//     K = k * 16 + plane, in the canonical K-major layout without swizzle
//     (8 x 16 B core matrices, LBO 128 B, SBO 768 B), padding rows and
//     planes zero.  A block of 16 scans x 16 planes stages a chunk's pieces
//     in shared memory and stores them as 16-B vectors (one row, 8
//     planes).  J and D: each chunk's 42 channels of every point go
//     through shared memory, summed per (scan, channel) over the chunk's
//     16 planes and then over the block's 4 chunks, in order, into
//     per-block partials (no atomics); no per-thread sums stay live across
//     rows_point, which keeps the kernel at two blocks per SM.
//   * Stage 2, hess_v3_pairs_kernel: grid (output tile of 128 x 128 of a
//     pair block, plane split), the split index slowest, so that the
//     blocks in flight read the same plane range and its pieces stay in
//     L2.  On a diagonal pair only the tiles on or below its diagonal.
//     One producer thread keeps 1-D bulk copies (cp.async.bulk, completion
//     on an mbarrier by bytes) of the A and B pieces of each chunk in
//     flight into a ring of 4 (bf16x3) or 3 (exact) stages; two consumer
//     warpgroups, 64 rows each, run every product of the split with wgmma
//     m64n128k16 into a fresh accumulator per chunk (48 terms), added in
//     chunk order into a register partial: one fp32 accumulator on the
//     tensor cores over many chunks drifts (PERF.md, §6).  setmaxnreg
//     gives the consumers 232 registers (64 partial + 64 fresh) and the
//     producer 40.
//   * The sum pass, hess_v3_sum_kernel, adds the split partials in split
//     order into the raw pair blocks (a diagonal pair's lower half, written
//     to both halves, so each block is exactly symmetric) and the
//     plane-tile partials of J and D in tile order.  No atomics: two
//     launches give the same bits.
//
// Build: see packed_kernels.cu (one nvcc per source, then one link).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows_point.cuh"
#include "sm90.cuh"

namespace {

constexpr int kJD = 42;                  // J (6) + D (36) channels per scan
constexpr int kBK = 16;                  // planes per chunk
constexpr int kKC = 3 * kBK;             // product depth per chunk: 48
constexpr int kT = 128;                  // output tile side (rows of A, B)
constexpr int kLBO = 128;                // K-adjacent core matrices
constexpr int kSBO = (kKC / 8) * 128;    // 8-row groups: 768 B
constexpr int kTileBytes = kT * kKC * 2; // one piece of one operand: 12 KB
constexpr int kPT = 4;                   // chunks per stage-1 block
constexpr int kSG = 16;                  // scans per stage-1 block
// stage 1's J/D channels of a chunk, [channel][scan * 16 + plane]; the odd
// row stride keeps the 16 channels that a half-warp sums on distinct banks
constexpr int kJDLD = kSG * kBK + 1;
constexpr int kJDBytes = kJD * kJDLD * 4;
constexpr int kCons = 2;                 // consumer warpgroups
constexpr int kThreads2 = 128 * (kCons + 1);
// registers a thread after setmaxnreg (168 at launch): 2 x 128 x 232 +
// 128 x 40 = 384 x 168
constexpr int kRegCons = 232;
constexpr int kRegProd = 40;

// Rows of a pose block's pieces, padded to whole output tiles.
__host__ __device__ inline int64_t padded_rows(int64_t Bw) {
  return cdiv(6 * Bw, kT) * kT;
}

// Byte offset of (row, K index) inside one (piece, block, chunk) block.
__device__ __forceinline__ int64_t piece_off(int64_t row, int kk) {
  return (row >> 3) * kSBO + (kk >> 3) * 128 + (row & 7) * 16 + (kk & 7) * 2;
}

// The output tiles: pair blocks in order, nT = RP / 128 tiles a side, all
// nT^2 of an off-diagonal pair, the nT (nT + 1) / 2 with ti >= tj of a
// diagonal one, row-major.
__device__ __forceinline__ int64_t tile_index(int64_t I, int64_t J, int ti,
                                              int tj, int64_t nT) {
  const int64_t F = nT * nT, Dg = nT * (nT + 1) / 2;
  const int64_t base = F * I * (I - 1) / 2 + I * Dg;
  return J < I ? base + J * F + ti * nT + tj
               : base + I * F + ti * (ti + 1) / 2 + tj;
}

__device__ __forceinline__ void tile_of(int64_t t, int64_t nT, int64_t& I,
                                        int64_t& J, int& ti, int& tj) {
  const int64_t F = nT * nT, Dg = nT * (nT + 1) / 2;
  I = 0;
  while (t >= I * F + Dg) {
    t -= I * F + Dg;
    ++I;
  }
  if (t < I * F) {
    J = t / F;
    t -= J * F;
    ti = (int)(t / nT);
    tj = (int)(t % nT);
  } else {
    J = I;
    t -= I * F;
    ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    tj = (int)(t - ti * (ti + 1) / 2);
  }
}

// ---- stage 1: the split's pieces ------------------------------------------

// Grid (plane tile of kPT chunks, 16-scan group over nB Bw scans).
// pieces holds P x nB x nchunk blocks of RP x 48 bf16; JDpart (nB Bw,
// n_ptile, 42).
// Thread (sl, pl) builds (scan sl, plane pl) of each chunk of its tile.
template <int P>
__global__ void __launch_bounds__(kSG * kBK, 2)
    hess_v3_pieces_kernel(const float* __restrict__ pose,
                          const float* __restrict__ mom,
                          const float* __restrict__ cen,
                          const float* __restrict__ aux,
                          uint16_t* __restrict__ pieces,
                          float* __restrict__ JDpart, int64_t Wp, int64_t Gp,
                          int64_t Bw, int64_t nB, int64_t nchunk) {
  __shared__ __align__(16) uint16_t buf[P][6][3][kSG][kBK];
  // the chunk's J/D channels (dynamic shared memory, kJDBytes)
  extern __shared__ float jdbuf[];
  const int sl = threadIdx.x / kBK, pl = threadIdx.x % kBK;
  const int64_t WpB = nB * Bw, RP = padded_rows(Bw);
  const int64_t w = (int64_t)blockIdx.y * kSG + sl;
  const bool w_live = w < Wp;
  // J/D sums of this thread: scan sl, channels pl + 16 i (< 42)
  float acc[3] = {0.f, 0.f, 0.f};
  // this thread's stores: scan s2 of the group, 8-plane half h, pose
  // block I_s; out0 is (piece 0, block I_s, chunk 0)
  const int s2 = threadIdx.x % kSG, h = (threadIdx.x / kSG) & 1;
  const int64_t ws = (int64_t)blockIdx.y * kSG + s2;
  const int64_t I_s = ws / Bw, wl_s = ws - I_s * Bw;
  const int64_t cbytes = RP * kKC * 2, pbytes = nB * nchunk * cbytes;
  unsigned char* out0 =
      reinterpret_cast<unsigned char*>(pieces) + I_s * nchunk * cbytes;
  const int64_t c0 = (int64_t)blockIdx.x * kPT;
  const int64_t c1 = c0 + kPT < nchunk ? c0 + kPT : nchunk;
  for (int64_t c = c0; c < c1; ++c) {
    const int64_t g = c * kBK + pl;
    float rw[6][3], jv[6], D[36];
    if (w_live && g < Gp) {
      float r[12], m[10], cv[3], ax[17];
      for (int i = 0; i < 12; ++i) r[i] = pose[w * 12 + i];
      for (int i = 0; i < 10; ++i) m[i] = mom[(w * 10 + i) * Gp + g];
      for (int i = 0; i < 3; ++i) cv[i] = cen[i * Gp + g];
      for (int i = 0; i < 17; ++i) ax[i] = aux[i * Gp + g];
      rows_point(r, m, cv, ax, rw, jv, D);
    } else {
      for (int j = 0; j < 6; ++j)
        for (int k = 0; k < 3; ++k) rw[j][k] = 0.f;
      for (int i = 0; i < 6; ++i) jv[i] = 0.f;
      for (int i = 0; i < 36; ++i) D[i] = 0.f;
    }
    __syncthreads();  // the previous chunk's stores and sums are done
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float x = rw[j][k];
        const __nv_bfloat16 hi = __float2bfloat16_rn(x);
        const float rem = __fsub_rn(x, __bfloat162float(hi));
        const __nv_bfloat16 mid = __float2bfloat16_rn(rem);
        buf[0][j][k][sl][pl] = __bfloat16_as_ushort(hi);
        buf[1][j][k][sl][pl] = __bfloat16_as_ushort(mid);
        if (P == 3)
          buf[P - 1][j][k][sl][pl] = __bfloat16_as_ushort(__float2bfloat16_rn(
              __fsub_rn(rem, __bfloat162float(mid))));
      }
#pragma unroll
    for (int i = 0; i < 6; ++i) jdbuf[i * kJDLD + threadIdx.x] = jv[i];
#pragma unroll
    for (int i = 0; i < 36; ++i) jdbuf[(6 + i) * kJDLD + threadIdx.x] = D[i];
    __syncthreads();
    // J/D: the chunk's 16 planes of (scan sl, channel), in plane order
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ch = pl + kBK * i;
      if (ch < kJD) {
        float v = 0.f;
        for (int q = 0; q < kBK; ++q) v += jdbuf[ch * kJDLD + sl * kBK + q];
        acc[i] += v;
      }
    }
    // 16-B segments of (piece, j, k) q, 8-plane half h and scan s2, with
    // consecutive threads on consecutive rows of one core-matrix column
    if (ws < WpB) {
      unsigned char* out_c = out0 + c * cbytes;
#pragma unroll
      for (int i = 0; i < (P * 18 + 7) / 8; ++i) {
        const int q = (int)(threadIdx.x / 32) + 8 * i;
        if (q < P * 18) {
          const int k = q % 3, j = (q / 3) % 6, p = q / 18;
          *reinterpret_cast<uint4*>(out_c + p * pbytes +
                                    piece_off(j * Bw + wl_s,
                                              k * kBK + 8 * h)) =
              *reinterpret_cast<const uint4*>(&buf[p][j][k][s2][8 * h]);
        }
      }
    }
  }
  if (w < WpB)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ch = pl + kBK * i;
      if (ch < kJD) JDpart[(w * gridDim.x + blockIdx.x) * kJD + ch] = acc[i];
    }
}

// Zeros of the padding rows [6 Bw, RP) of every (piece, block, chunk).
__global__ void hess_v3_pad_kernel(uint16_t* __restrict__ pieces,
                                   int64_t nblk, int64_t Bw) {
  const int64_t RP = padded_rows(Bw), r0 = 6 * Bw;
  const int64_t per = (RP - r0) * (kKC / 8);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < nblk * per; i += stride) {
    const int64_t b = i / per, e = i % per;
    unsigned char* blk =
        reinterpret_cast<unsigned char*>(pieces) + b * RP * kKC * 2;
    *reinterpret_cast<uint4*>(blk + piece_off(r0 + e / (kKC / 8),
                                              (int)(e % (kKC / 8)) * 8)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---- stage 2: the pair blocks on the tensor cores -------------------------

template <int P>
struct PairSmem {
  static constexpr int kStages = P == 2 ? 4 : 3;
  static constexpr int kStage = 2 * P * kTileBytes;  // A pieces, B pieces
  static constexpr int kBar = kStages * kStage;
  static constexpr int kBytes = kBar + 2 * kStages * 8;  // full, empty
};

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = [d +] A B^T over one k16 step; A, B from shared
// memory by descriptor
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// Grid (tile, split), tile fastest; writes the split's partial tile
// Hpart[s][tile] (128 x 128, pair-block rows and columns of the tile).
template <int P>
__global__ void __launch_bounds__(kThreads2, 1)
    hess_v3_pairs_kernel(const uint16_t* __restrict__ pieces,
                         float* __restrict__ Hpart, int64_t nB, int64_t Bw,
                         int64_t nchunk, int64_t ntiles) {
  using S = PairSmem<P>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t RP = padded_rows(Bw), nT = RP / kT;
  const int64_t tile = blockIdx.x % ntiles, s = blockIdx.x / ntiles;
  const int64_t nsplit = gridDim.x / ntiles;
  int64_t I, J;
  int ti, tj;
  tile_of(tile, nT, I, J, ti, tj);
  const bool same = I == J && ti == tj;  // A and B are the same rows
  const int64_t c0 = s * nchunk / nsplit, c1 = (s + 1) * nchunk / nsplit;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* empty = full + S::kStages;
  if (threadIdx.x == 0) {
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one big branch per role, never reconverging
  if (threadIdx.x >= 128 * kCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegProd));
    if (threadIdx.x == 128 * kCons) {
      const int64_t blk = RP * kKC;               // bf16 of one block
      const int64_t pstride = nB * nchunk * blk;  // between pieces
      const uint16_t* a0 = pieces + I * nchunk * blk + ti * kT * kKC;
      const uint16_t* b0 = pieces + J * nchunk * blk + tj * kT * kKC;
      const uint32_t bytes = (same ? 1 : 2) * P * kTileBytes;
      for (int64_t c = c0; c < c1; ++c) {
        const int64_t n = c - c0;
        const int st = (int)(n % S::kStages);
        if (n >= S::kStages)
          mbar_wait(&empty[st], (uint32_t)((n / S::kStages - 1) & 1));
        mbar_expect_tx(&full[st], bytes);
        unsigned char* dst = smem + st * S::kStage;
        for (int p = 0; p < P; ++p) {
          bulk_load(dst + p * kTileBytes, a0 + p * pstride + c * blk,
                    kTileBytes, &full[st]);
          if (!same)
            bulk_load(dst + (P + p) * kTileBytes, b0 + p * pstride + c * blk,
                      kTileBytes, &full[st]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegCons));
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    const int wi = (threadIdx.x >> 5) & 3;
    const uint32_t base = smem_u32(smem);
    float h[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) h[i] = d[i] = 0.f;
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t n = c - c0;
      const int st = (int)(n % S::kStages);
      mbar_wait(&full[st], (uint32_t)((n / S::kStages) & 1));
      const uint32_t a_base = base + st * S::kStage;
      const uint32_t b_base = same ? a_base : a_base + P * kTileBytes;
      acc_fence(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
        for (int e = 0; e < n_products(P); ++e) {
          const uint64_t da = wgmma_desc(a_base + prod_a(e) * kTileBytes +
                                             wg * 8 * kSBO + kk * 2 * kLBO,
                                         kLBO, kSBO);
          const uint64_t db = wgmma_desc(
              b_base + prod_b(e) * kTileBytes + kk * 2 * kLBO, kLBO, kSBO);
          wgmma_128(d, da, db, kk + e > 0);
        }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      acc_fence(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < 64; ++i) h[i] += d[i];
    }
    // entry i of a thread: row 16 wi + lane / 4 + 8 ((i / 2) % 2), column
    // 8 (i / 4) + 2 (lane % 4) + i % 2 of the strip (wgmma's layout)
    float* Ht = Hpart + (s * ntiles + tile) * (int64_t)kT * kT;
    const int row = 64 * wg + 16 * wi + (lane >> 2);
#pragma unroll
    for (int cb = 0; cb < 16; ++cb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(Ht + (row + 8 * r) * kT + 8 * cb +
                                   2 * (lane & 3)) =
            make_float2(h[4 * cb + 2 * r], h[4 * cb + 2 * r + 1]);
  }
}

// The raw pair blocks Hblk (n_pairs, 6 Bw, 6 Bw) from the split partials
// in split order, and J (nB Bw, 6), D (nB Bw, 36) from the plane-tile
// partials in tile order.  Blocks [0, ntiles 128) each sum one row of a
// partial tile (coalesced over the splits) into its pair block's entries;
// on a diagonal pair only those on or below its diagonal, each also
// written to its mirror.  The rest sum one J/D entry a thread.
__global__ void hess_v3_sum_kernel(const float* __restrict__ Hpart,
                                   const float* __restrict__ JDpart,
                                   float* __restrict__ Hblk,
                                   float* __restrict__ J,
                                   float* __restrict__ D, int64_t nB,
                                   int64_t Bw, int64_t ntiles, int64_t nsplit,
                                   int64_t nptile) {
  const int64_t n6 = 6 * Bw, nT = padded_rows(Bw) / kT;
  const int64_t tsz = (int64_t)kT * kT;
  const int64_t b = blockIdx.x;
  if (b < ntiles * kT) {
    const int64_t tile = b / kT;
    int64_t I, Jb;
    int ti, tj;
    tile_of(tile, nT, I, Jb, ti, tj);
    const int64_t r = (int64_t)ti * kT + b % kT;
    const int64_t c = (int64_t)tj * kT + threadIdx.x;
    if (r >= n6 || c >= n6 || (I == Jb && r < c)) return;
    const float* src = Hpart + b * kT + threadIdx.x;
    const int64_t stride = ntiles * tsz;
    float acc = 0.f;
    int64_t s = 0;
    for (; s + 4 <= nsplit; s += 4) {  // in split order, loads 4 ahead
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = src[(s + u) * stride];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += v[u];
    }
    for (; s < nsplit; ++s) acc += src[s * stride];
    float* Hq = Hblk + (I * (I + 1) / 2 + Jb) * n6 * n6;
    Hq[r * n6 + c] = acc;
    if (I == Jb) Hq[c * n6 + r] = acc;
  } else {
    const int64_t i = (b - ntiles * kT) * blockDim.x + threadIdx.x;
    if (i >= nB * Bw * kJD) return;
    const int64_t w = i / kJD;
    const int ch = (int)(i % kJD);
    // in tile order, loads 8 ahead: a thread's partials are its only work
    const float* src = JDpart + w * nptile * kJD + ch;
    float acc = 0.f;
    int64_t t = 0;
    for (; t + 8 <= nptile; t += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = src[(t + u) * kJD];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; t < nptile; ++t) acc += src[t * kJD];
    if (ch < 6) J[w * 6 + ch] = acc;
    else D[w * 36 + ch - 6] = acc;
  }
}

template <int P>
cudaError_t launch_pieces(const float* pose, const float* mom,
                          const float* cen, const float* aux,
                          uint16_t* pieces, float* JDpart, int64_t Wp,
                          int64_t Gp, int64_t Bw, cudaStream_t stream) {
  const int64_t nB = cdiv(Wp, Bw), nchunk = cdiv(Gp, kBK);
  const dim3 grid((unsigned)cdiv(nchunk, kPT), (unsigned)cdiv(nB * Bw, kSG));
  cudaError_t err = allow_smem(hess_v3_pieces_kernel<P>, kJDBytes);
  if (err != cudaSuccess) return err;
  hess_v3_pieces_kernel<P><<<grid, kSG * kBK, kJDBytes, stream>>>(
      pose, mom, cen, aux, pieces, JDpart, Wp, Gp, Bw, nB, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || padded_rows(Bw) == 6 * Bw) return err;
  const int64_t n = P * nB * nchunk * (padded_rows(Bw) - 6 * Bw) * (kKC / 8);
  const int64_t blocks = cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096;
  hess_v3_pad_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      pieces, P * nB * nchunk, Bw);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_pairs(const uint16_t* pieces, const float* JDpart,
                         float* Hpart, float* Hblk, float* J, float* D,
                         int64_t Wp, int64_t Gp, int64_t Bw, int64_t nsplit,
                         cudaStream_t stream) {
  const int bytes = PairSmem<P>::kBytes;
  cudaError_t err = allow_smem(hess_v3_pairs_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  const int64_t nB = cdiv(Wp, Bw), nchunk = cdiv(Gp, kBK);
  const int64_t nT = padded_rows(Bw) / kT;
  const int64_t ntiles =
      nB * (nB - 1) / 2 * nT * nT + nB * nT * (nT + 1) / 2;
  hess_v3_pairs_kernel<P>
      <<<(unsigned)(ntiles * nsplit), kThreads2, bytes, stream>>>(
          pieces, Hpart, nB, Bw, nchunk, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = ntiles * kT + cdiv(nB * Bw * kJD, kT);
  hess_v3_sum_kernel<<<(unsigned)blocks, kT, 0, stream>>>(
      Hpart, JDpart, Hblk, J, D, nB, Bw, ntiles, nsplit,
      cdiv(nchunk, kPT));
  return cudaGetLastError();
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// As in packed_kernels.cu: each launcher selects the device, enqueues on
// the given stream, does not synchronise, and returns cudaGetLastError().
// `pieces` is 2 (bf16x3) or 3 (exact).

// B5's scratch at this shape: out[0] bf16 values of the pieces, out[1]
// floats of the J/D partials, out[2] floats of one split's partial tiles,
// out[3] the plane splits (from the SM count: about three waves of one
// block per SM, at most one split per chunk).  Returns a CUDA error or 0.
extern "C" int balm_hess_v3_plan(int64_t Wp, int64_t Gp, int64_t Bw,
                                 int pieces, int device, int64_t* out) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t nB = cdiv(Wp, Bw), nchunk = cdiv(Gp, kBK);
  const int64_t nT = padded_rows(Bw) / kT;
  const int64_t ntiles =
      nB * (nB - 1) / 2 * nT * nT + nB * nT * (nT + 1) / 2;
  int64_t s = (3 * (int64_t)sms + ntiles / 2) / ntiles;
  if (s > nchunk) s = nchunk;
  out[0] = pieces * nB * nchunk * padded_rows(Bw) * kKC;
  out[1] = nB * Bw * cdiv(nchunk, kPT) * kJD;
  out[2] = ntiles * kT * kT;
  out[3] = s < 1 ? 1 : s;
  return 0;
}

// Stage 1: the pieces and the J/D partials.
extern "C" int balm_hess_v3_pieces(const float* pose, const float* mom,
                                   const float* cen, const float* aux,
                                   uint16_t* pieces, float* JDpart,
                                   int64_t Wp, int64_t Gp, int64_t Bw,
                                   int npieces, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(npieces == 2
                   ? launch_pieces<2>(pose, mom, cen, aux, pieces, JDpart, Wp,
                                      Gp, Bw, st)
                   : launch_pieces<3>(pose, mom, cen, aux, pieces, JDpart, Wp,
                                      Gp, Bw, st));
}

// Stage 2 and the sum pass: the raw pair blocks, J and D.
extern "C" int balm_hess_v3_pairs(const uint16_t* pieces, const float* JDpart,
                                  float* Hpart, float* Hblk, float* J,
                                  float* D, int64_t Wp, int64_t Gp,
                                  int64_t Bw, int npieces, int64_t nsplit,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(npieces == 2
                   ? launch_pairs<2>(pieces, JDpart, Hpart, Hblk, J, D, Wp,
                                     Gp, Bw, nsplit, st)
                   : launch_pairs<3>(pieces, JDpart, Hpart, Hblk, J, D, Wp,
                                     Gp, Bw, nsplit, st));
}
