// CUDA C++ kernels B4 and B6 of the fused-Hessian packed evaluate, for
// sm_90a.
//
// Both compute one function of the packed layout (see
// packed_kernels.cu for the arrays): the rank rows of every (scan, plane)
// -- rows_point, the same device body as B2 `rows` -- and, without ever
// writing the rows to device memory,
//   Htilde = sum_k M_k M_k^T,  M_k (6Wp, Gp) with row j * Wp + w,
// plus J (Wp, 6) and D (Wp, 36), the sums over planes of the gradient and
// block-diagonal channels.  Htilde is (j, w)-major like the TPU kernels'.
//
// What bounds them on the H100: operations.  At Wp = 256, Gp = 11520 the
// symmetric Htilde needs only its lower triangle, 1536 * 1537 * 34560 =
// 81.6 GFLOP per product pass; a kernel also rebuilds the rows of its
// output tile's scans once per tile: ~870 FLOP per (scan, plane), 2.57
// GFLOP per pass over the problem on the fp32 SIMT pipe (67 TFLOP/s).
//
// B4 `hess_v2` and B6 `hess_v1` (one template, hess_tri_kernel) run the
// product on the tensor cores as a split of each fp32 row value into bf16
// pieces, products accumulated in fp32 (wgmma):
//   * bf16x3: hi = bf16(x), lo = bf16(x - hi), both rounded to nearest
//     even; Htilde = hi hi^T + hi lo^T + lo hi^T.  This is the TPU kernel's
//     own product (`split='bf16x3'`, pallas_evaluate.py:522-533): 3 passes,
//     0.25 ms of tensor-core time at 989 TFLOP/s.
//   * exact: hi, mid = bf16(x - hi), lo = bf16(x - hi - mid) (x = hi +
//     mid + lo exactly), and the six products that do not drop below
//     fp32's 24 bits: hh, hm, mh, hl, lh, mm -- the TPU's Precision.HIGHEST
//     (B6's dot, and B4 with `split='f32'`): 6 passes, 0.50 ms.
// Design (tiles of BT = 32 scans a side, (6 BT)^2 = 192 x 192 entries):
//   * Only the lower-triangle tiles (ti >= tj; 36 at Wp = 256), each
//     rows build serving the 6 j of its scans.  Grid (tile, plane split),
//     the splits chosen so that the blocks fill three waves of the SMs;
//     one block per SM (512 threads, 150 KB (bf16x3) or 224 KB (exact) of
//     shared memory).
//   * Warp specialisation: warpgroup 3 builds the rows; per chunk of BK =
//     16 planes it runs rows_point for its points (inputs from global
//     memory through L1/L2; off the diagonal one plane a thread, its cen
//     and aux once a chunk, the next point's moments loaded during the
//     current one), splits each value and writes the pieces into a
//     2-stage operand ring in wgmma's canonical K-major layout without
//     swizzle (8 x 16 B core matrices, K = 48 = 3 k16 steps a chunk).
//     Warpgroups 0-2 are the consumers, each owning a 64-row strip of the
//     tile.  mbarriers guard the ring (full: 128 builder arrivals after a
//     proxy fence; empty: one per consumer warp).  The rows pass runs on
//     the SIMT pipe while the consumers' wgmma run on the chunk before on
//     the tensor cores.  setmaxnreg gives the consumers 136 registers and
//     the builder 104.
//   * Accumulation: per chunk and quarter of its strip's columns a
//     consumer runs every product of the split into a fresh accumulator
//     (wgmma m64n48k16, 48 terms a product), then adds it in a fixed order
//     into its running partial, 96 registers a thread.  The tensor
//     cores' fp32 accumulation loses more than an FMA's: one accumulator
//     over eight chunks put the exact split several times further from an
//     f64 product than a fresh one per chunk does, and flushing every
//     chunk to a partial in global memory instead doubled the time.  The
//     price is the A strip read four times a chunk (once a quarter), the
//     register budget allowing no wider fresh accumulator.  At the end
//     each block stores its partial tile; a second pass sums the split
//     partials in split order and writes both triangles of Htilde (a
//     diagonal tile's lower half, mirrored) and J, D.  No atomics: two
//     launches give the same bits.
//   * J and D come from the diagonal tiles (one side built): each builder
//     thread adds its points' 42 channels into its own slots (in the
//     unused B half of the operand ring), summed in a fixed order at the
//     end.
// B4 replaces the Pallas `_hess_kernel_v2` (balm_tpu/ops/pallas_evaluate.py
// :491, wrapper hess_packed_v2 :552), B6 the Pallas `_hess_kernel` (:284,
// wrapper hess_packed :444).  On the TPU both accumulate Htilde across a
// sequential plane grid; on the card the plane splits run in parallel and
// the cross-block sum is the second pass.
//
// B5 `hess_v3` (the Pallas `_hess_kernel_v3`, :604) lives in
// hess_v3_kernels.cu: the rows built once into bf16 pieces in device
// memory, then the pose-block-pair product from bulk copies.
//
// Build: see packed_kernels.cu (one nvcc per source, then one link).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows_point.cuh"
#include "sm90.cuh"

namespace {

constexpr int kJDc = 42;        // J (6) + D (36) channels per scan

// ---- B4 and B6: lower-triangle tiles on the tensor cores ------------------

constexpr int kTB = 32;                  // scans per tile side
constexpr int kTN = 6 * kTB;             // tile side: 192 rows (j * 32 + scan)
constexpr int kTBK = 16;                 // planes per chunk
constexpr int kTK = 3 * kTBK;            // product depth per chunk: 48
constexpr int kTCons = 3;                // consumer warpgroups (64-row strips)
constexpr int kTThreads = 128 * (kTCons + 1);
constexpr int kPiece = kTN * kTK * 2;    // one bf16 piece of one side: 18 KB
// wgmma's canonical K-major layout without swizzle: core matrices of 8
// rows x 16 B (8 bf16 along K) stored as 128 contiguous bytes; the core
// matrices of one 8-row group follow each other along K (LBO = 128 B),
// and 8-row groups are SBO = (48 / 8) * 128 = 768 B apart.
constexpr int kLBO = 128;
constexpr int kSBO = (kTK / 8) * 128;
constexpr int kPoseFloats = 2 * kTB * 12;
// registers a thread after setmaxnreg (128 at launch): 3 x 128 x 136 +
// 128 x 104 = 65,536
constexpr int kRegCons = 136;
constexpr int kRegBuild = 104;

__device__ __forceinline__ int tri_off(int r, int k) {
  return (r >> 3) * kSBO + (k >> 3) * kLBO + (r & 7) * 16 + (k & 7) * 2;
}

template <int P>
struct TriSmem {
  static constexpr int kStage = 2 * P * kPiece;  // both sides' pieces
  static constexpr int kPose = 2 * kStage;
  static constexpr int kBar = kPose + kPoseFloats * 4;
  static constexpr int kBytes = kBar + 4 * 8;    // full[2], empty[2]
};

__device__ __forceinline__ void acc_fence(float (&d)[24]) {
#pragma unroll
  for (int i = 0; i < 24; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 48, fp32) = [d +] A B^T over one k16 step; A, B from shared
// memory by descriptor
__device__ __forceinline__ void wgmma_48(float (&d)[24], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The pieces of x into piece 0.. of one side at byte offset off.
template <int P>
__device__ __forceinline__ void store_pieces(unsigned char* side, int off,
                                             float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *reinterpret_cast<unsigned short*>(side + off) = __bfloat16_as_ushort(h);
  const float r = __fsub_rn(x, __bfloat162float(h));
  const __nv_bfloat16 m = __float2bfloat16_rn(r);
  *reinterpret_cast<unsigned short*>(side + kPiece + off) =
      __bfloat16_as_ushort(m);
  if (P == 3) {
    const __nv_bfloat16 l =
        __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(m)));
    *reinterpret_cast<unsigned short*>(side + 2 * kPiece + off) =
        __bfloat16_as_ushort(l);
  }
}

// A pose row (12 floats, 48 B) from shared memory in three 16-B loads.
__device__ __forceinline__ void load_pose(const float4* p, float (&r)[12]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 v = p[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

// Warpgroup 3 builds the rows of chunks [c0, c1) into the operand ring;
// the consumers release a stage (empty barrier) once its wgmma are done.
// Off-diagonal tiles: each thread builds one plane of the chunk for 4
// scans of each side, loading the plane's cen and aux once a chunk and the
// next point's moments while it builds the current one.  A warp covers 8
// planes x 4 scans, so that its 2-byte stores of one (j, k, piece) fall on
// 64 contiguous bytes of one core-matrix column: no bank conflicts.
template <int P>
__device__ __forceinline__ void tri_build_off(
    unsigned char* smem, const float* __restrict__ mom,
    const float* __restrict__ cen, const float* __restrict__ aux, int64_t Wp,
    int64_t Gp, int64_t ti, int64_t tj, int64_t c0, int64_t c1) {
  using S = TriSmem<P>;
  const int t = threadIdx.x - 128 * kTCons;
  const int lane = t & 31, wp = t >> 5;
  const int pl = (lane & 7) + 8 * (wp & 1), sg = (lane >> 3) + 4 * (wp >> 1);
  const float4* spose = reinterpret_cast<const float4*>(smem + S::kPose);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::kBar);
  // point pt < 8: side pt / 4, scan sg + 8 (pt % 4) of the side's tile
  auto scan = [&](int pt) {
    return ((pt >> 2) ? tj : ti) * kTB + sg + 8 * (pt & 3);
  };
  for (int64_t c = c0; c < c1; ++c) {
    const int64_t n = c - c0;
    const int st = (int)(n & 1);
    if (n >= 2) mbar_wait(&bar[2 + st], (uint32_t)(((n >> 1) - 1) & 1));
    unsigned char* stage = smem + st * S::kStage;
    const int64_t g = c * kTBK + pl;
    const bool g_live = g < Gp;
    float cv[3], ax[17], mn[10];
    if (g_live) {
      for (int k = 0; k < 3; ++k) cv[k] = cen[k * Gp + g];
      for (int k = 0; k < 17; ++k) ax[k] = aux[k * Gp + g];
    }
    if (g_live && scan(0) < Wp)
      for (int k = 0; k < 10; ++k) mn[k] = mom[(scan(0) * 10 + k) * Gp + g];
#pragma unroll 1
    for (int pt = 0; pt < 8; ++pt) {
      const bool live = g_live && scan(pt) < Wp;
      float m[10];
      for (int k = 0; k < 10; ++k) m[k] = mn[k];
      if (pt + 1 < 8 && g_live && scan(pt + 1) < Wp)
        for (int k = 0; k < 10; ++k)
          mn[k] = mom[(scan(pt + 1) * 10 + k) * Gp + g];
      const int row = sg + 8 * (pt & 3);
      float rw[6][3];
      if (live) {
        float r[12], jv[6], D[36];
        load_pose(spose + ((pt >> 2) * kTB + row) * 3, r);
        rows_point(r, m, cv, ax, rw, jv, D);
      } else {
        for (int j = 0; j < 6; ++j)
          for (int k = 0; k < 3; ++k) rw[j][k] = 0.f;
      }
      unsigned char* dst = stage + (pt >> 2) * P * kPiece;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          store_pieces<P>(dst, tri_off(j * kTB + row, k * kTBK + pl),
                          rw[j][k]);
    }
    // the generic-proxy stores, visible to the consumers' wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&bar[st]);
  }
}

// Diagonal tiles (one side): thread t = 4 u + q builds scan u for the
// chunk's planes q + 4 i (i < 4) and adds their J and D channels into its
// own slots (the unused B half of stage 0), summed in a fixed order into
// the split's JDpart at the end.
template <int P>
__device__ __forceinline__ void tri_build_diag(
    unsigned char* smem, const float* __restrict__ mom,
    const float* __restrict__ cen, const float* __restrict__ aux,
    float* __restrict__ JDpart, int64_t Wp, int64_t Gp, int64_t ti,
    int64_t s, int64_t c0, int64_t c1) {
  using S = TriSmem<P>;
  const int t = threadIdx.x - 128 * kTCons;
  const int u = t >> 2, q = t & 3;
  const int64_t w = ti * kTB + u;
  float r[12];
  load_pose(reinterpret_cast<const float4*>(smem + S::kPose) + u * 3, r);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::kBar);
  float* jd = reinterpret_cast<float*>(smem + P * kPiece);
  for (int ch = 0; ch < kJDc; ++ch) jd[ch * 128 + t] = 0.f;
  for (int64_t c = c0; c < c1; ++c) {
    const int64_t n = c - c0;
    const int st = (int)(n & 1);
    if (n >= 2) mbar_wait(&bar[2 + st], (uint32_t)(((n >> 1) - 1) & 1));
    unsigned char* stage = smem + st * S::kStage;
    for (int i = 0; i < 4; ++i) {
      const int pl = q + 4 * i;
      const int64_t g = c * kTBK + pl;
      float rw[6][3];
      if (g < Gp && w < Wp) {
        float m[10], cv[3], ax[17], jv[6], D[36];
        for (int k = 0; k < 3; ++k) cv[k] = cen[k * Gp + g];
        for (int k = 0; k < 17; ++k) ax[k] = aux[k * Gp + g];
        for (int k = 0; k < 10; ++k) m[k] = mom[(w * 10 + k) * Gp + g];
        rows_point(r, m, cv, ax, rw, jv, D);
        for (int k = 0; k < 6; ++k) jd[k * 128 + t] += jv[k];
        for (int k = 0; k < 36; ++k) jd[(6 + k) * 128 + t] += D[k];
      } else {
        for (int j = 0; j < 6; ++j)
          for (int k = 0; k < 3; ++k) rw[j][k] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          store_pieces<P>(stage, tri_off(j * kTB + u, k * kTBK + pl),
                          rw[j][k]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&bar[st]);
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  const int64_t w0 = ti * kTB;
  const int nsc = (int)(Wp - w0 < kTB ? Wp - w0 : kTB);
  float* JD = JDpart + (s * Wp + w0) * kJDc;
  for (int idx = t; idx < nsc * kJDc; idx += 128) {
    const int a = idx / kJDc, ch = idx % kJDc;
    float v = 0.f;
    for (int qq = 0; qq < 4; ++qq) v += jd[ch * 128 + 4 * a + qq];
    JD[idx] = v;
  }
}

// Stores the strip's partial into the block's partial tile.  Entry i of
// a thread: row 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (lane % 4) + i % 2 of the strip (wgmma's accumulator layout).
__device__ __forceinline__ void tri_store(const float (&h)[96],
                                          float* __restrict__ Ht, int strip) {
  const int lane = threadIdx.x & 31, wi = (threadIdx.x >> 5) & 3;
  const int row = 64 * strip + 16 * wi + (lane >> 2);
#pragma unroll
  for (int cb = 0; cb < 24; ++cb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(Ht + (row + 8 * r) * kTN + 8 * cb +
                                 2 * (lane & 3)) =
          make_float2(h[4 * cb + 2 * r], h[4 * cb + 2 * r + 1]);
}

// Warpgroups 0-2: the strip's product over chunks [c0, c1).  Per chunk
// and quarter of the strip's 192 columns, a fresh wgmma accumulator (48
// product terms of the chunk, every product of the split) is added in
// order into the running partial h (registers), so that no fp32 sum on
// the tensor cores runs over more than one chunk.
template <int P>
__device__ __forceinline__ void tri_consume(unsigned char* smem,
                                            float* __restrict__ Ht, bool diag,
                                            int64_t c0, int64_t c1) {
  using S = TriSmem<P>;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::kBar);
  const int strip = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(smem);
  float h[96], d[24];
#pragma unroll
  for (int i = 0; i < 96; ++i) h[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 24; ++i) d[i] = 0.f;
  for (int64_t c = c0; c < c1; ++c) {
    const int64_t n = c - c0;
    const int st = (int)(n & 1);
    mbar_wait(&bar[st], (uint32_t)((n >> 1) & 1));
    const uint32_t a_base = base + st * S::kStage;
    const uint32_t b_base = diag ? a_base : a_base + P * kPiece;
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) {
      acc_fence(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 3; ++kk)
#pragma unroll
        for (int e = 0; e < n_products(P); ++e) {
          const uint64_t da = wgmma_desc(a_base + prod_a(e) * kPiece +
                                             strip * 8 * kSBO +
                                             kk * 2 * kLBO,
                                         kLBO, kSBO);
          const uint64_t db = wgmma_desc(b_base + prod_b(e) * kPiece +
                                             qt * 6 * kSBO + kk * 2 * kLBO,
                                         kLBO, kSBO);
          wgmma_48(d, da, db, kk + e > 0);
        }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      acc_fence(d);
#pragma unroll
      for (int i = 0; i < 24; ++i) h[24 * qt + i] += d[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar[2 + st]);
  }
  tri_store(h, Ht, strip);
}

// B4 and B6: grid (lower tile p, plane split s); tile p = (ti, tj), ti >=
// tj, in the order (0,0), (1,0), (1,1), (2,0), ...  Writes the split's
// partial tile Hpart[s][p] (192 x 192, tile-local (j * 32 + scan) order)
// and, on a diagonal tile, the split's J/D partials JDpart[s][w] (42).
template <int P>
__global__ void __launch_bounds__(kTThreads, 1)
    hess_tri_kernel(const float* __restrict__ pose,
                    const float* __restrict__ mom,
                    const float* __restrict__ cen,
                    const float* __restrict__ aux, float* __restrict__ Hpart,
                    float* __restrict__ JDpart, int64_t Wp, int64_t Gp) {
  using S = TriSmem<P>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t p = blockIdx.x, s = blockIdx.y, nsplit = gridDim.y;
  int64_t ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  const int64_t tj = p - ti * (ti + 1) / 2;
  const int64_t nchunk = cdiv(Gp, kTBK);
  const int64_t c0 = s * nchunk / nsplit, c1 = (s + 1) * nchunk / nsplit;
  float* spose = reinterpret_cast<float*>(smem + S::kPose);
  for (int idx = threadIdx.x; idx < kPoseFloats; idx += kTThreads) {
    const int side = idx / (kTB * 12), rem = idx % (kTB * 12);
    const int64_t w = (side ? tj : ti) * kTB + rem / 12;
    spose[idx] = w < Wp ? pose[w * 12 + rem % 12] : 0.f;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::kBar);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 128);
    mbar_init(&bar[1], 128);
    mbar_init(&bar[2], 4 * kTCons);
    mbar_init(&bar[3], 4 * kTCons);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool diag = ti == tj;
  // one big branch per role, never reconverging: the builder gives up
  // registers to the consumers, whose partial and accumulator take 120
  if (threadIdx.x >= 128 * kTCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegBuild));
    if (diag)
      tri_build_diag<P>(smem, mom, cen, aux, JDpart, Wp, Gp, ti, s, c0, c1);
    else
      tri_build_off<P>(smem, mom, cen, aux, Wp, Gp, ti, tj, c0, c1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegCons));
    float* Ht = Hpart + (s * gridDim.x + p) * (int64_t)kTN * kTN;
    tri_consume<P>(smem, Ht, diag, c0, c1);
  }
}

// The second pass: Htilde (6Wp, 6Wp) from the split partials of the lower
// tiles, summed in split order, each entry written with its mirror (a
// diagonal tile gives only its entries on or below the diagonal of
// Htilde); J (Wp, 6) and D (Wp, 36) from the (nsplit, Wp, 42) partials.
__global__ void hess_tri_sum_kernel(const float* __restrict__ Hpart,
                                    const float* __restrict__ JDpart,
                                    float* __restrict__ H,
                                    float* __restrict__ J,
                                    float* __restrict__ D, int64_t Wp,
                                    int64_t ntile, int64_t nsplit) {
  const int64_t tile = (int64_t)kTN * kTN, nh = ntile * tile;
  const int64_t njd = Wp * kJDc, n6 = 6 * Wp;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < nh + njd; i += stride) {
    if (i < nh) {
      const int64_t p = i / tile;
      const int e = (int)(i % tile), r = e / kTN, c = e % kTN;
      int64_t ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
      const int64_t tj = p - ti * (ti + 1) / 2;
      const int64_t w = ti * kTB + r % kTB, w2 = tj * kTB + c % kTB;
      if (w >= Wp || w2 >= Wp) continue;
      const int64_t R = (r / kTB) * Wp + w, C = (c / kTB) * Wp + w2;
      if (ti == tj && R < C) continue;
      float acc = 0.f;
      for (int64_t s = 0; s < nsplit; ++s) acc += Hpart[s * nh + i];
      H[R * n6 + C] = acc;
      H[C * n6 + R] = acc;
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

template <int P>
cudaError_t launch_tri(const float* pose, const float* mom, const float* cen,
                       const float* aux, float* Hpart, float* JDpart,
                       float* H, float* J, float* D, int64_t Wp, int64_t Gp,
                       int64_t nsplit, cudaStream_t stream) {
  const int bytes = TriSmem<P>::kBytes;
  cudaError_t err = allow_smem(hess_tri_kernel<P>, bytes);
  if (err != cudaSuccess) return err;
  const int64_t nT = cdiv(Wp, kTB), ntile = nT * (nT + 1) / 2;
  hess_tri_kernel<P>
      <<<dim3((unsigned)ntile, (unsigned)nsplit), kTThreads, bytes, stream>>>(
          pose, mom, cen, aux, Hpart, JDpart, Wp, Gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = ntile * kTN * kTN + Wp * kJDc;
  const int64_t blocks = cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096;
  hess_tri_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      Hpart, JDpart, H, J, D, Wp, ntile, nsplit);
  return cudaGetLastError();
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// As in packed_kernels.cu: each launcher selects the device, enqueues on
// the given stream, does not synchronise, and returns cudaGetLastError().

// Plane splits of B4 and B6 at this shape: (lower tile, split) blocks for
// three waves of one block per SM, at most one split per plane chunk.
extern "C" int balm_hess_splits(int64_t Wp, int64_t Gp, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  const int64_t nT = cdiv(Wp, kTB), ntile = nT * (nT + 1) / 2;
  const int64_t nchunk = cdiv(Gp, kTBK);
  int64_t s = (3 * (int64_t)sms + ntile / 2) / ntile;
  if (s > nchunk) s = nchunk;
  return (int)(s < 1 ? 1 : s);
}

// Floats of one split's partials of B4 and B6: the lower tiles' 192 x 192
// entries.
extern "C" int64_t balm_hess_tile_floats(int64_t Wp) {
  const int64_t nT = cdiv(Wp, kTB);
  return nT * (nT + 1) / 2 * kTN * kTN;
}

// B4 and B6: the bf16x3 split (split 1, B4's default) or the exact one
// (split 0: B6, and B4 with split='f32').
extern "C" int balm_hess_tri(const float* pose, const float* mom,
                             const float* cen, const float* aux, float* Hpart,
                             float* JDpart, float* H, float* J, float* D,
                             int64_t Wp, int64_t Gp, int64_t nsplit,
                             int split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(split ? launch_tri<2>(pose, mom, cen, aux, Hpart, JDpart, H, J,
                                     D, Wp, Gp, nsplit, st)
                     : launch_tri<3>(pose, mom, cen, aux, Hpart, JDpart, H, J,
                                     D, Wp, Gp, nsplit, st));
}
