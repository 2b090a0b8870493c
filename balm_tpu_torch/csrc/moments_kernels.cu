// CUDA C++ kernel B7 of the port, for sm_90a: the fused one-pass plane
// moment accumulation of the residual path.
//
// B7 `moments` replaces the Pallas `_kernel` (balm_tpu/ops/
// pallas_moments.py:41, wrapper accumulate_moments :89).  Per plane g
//
//   Csum[g] = sum_w T'_gw C_gw T'_gw^T,   T'_gw = [R_w | t'_gw],
//
// over the 10 channels (xx, xy, xz, yy, yz, zz, x, y, z, N), from the
// channels-major layout of balm_tpu_torch/ops/moments.py:
//   R9  (W, 9)      row-major rotations
//   CH  (W, 10, G)  body moment channels (vech P, v, N)
//   OFS (W, 3, G)   effective translations t'_gw
// -> out (10, G).  The plane axis is contiguous, so a warp of 32 planes
// reads every channel coalesced.  The arithmetic is the Pallas kernel's:
// A = R P, M = A R^T (upper 6), Rv = R v, and the t terms (add_entry, the
// one copy of it).  t' comes in as an input (formed in the glue as on the
// path without the kernel), so its cancellation R b + t - c is not
// re-rounded here.  Templated on the scalar type: float on the card's f32
// path, double for the f64 path.
//
// The kernel relies on the layout's invariant (ops/moments.pack_inputs
// enforces it): an entry with N == 0 has P == 0 and v == 0.  Such an
// entry adds exactly +-0 to every sum (each of its products has a zero
// factor), and a sum that starts at +0 is never -0, so skipping it keeps
// the bits.  (An empty entry with a non-finite t' would have turned 0 *
// inf into NaN in a dense loop; factors built from points never carry
// one.)  On a voxelized scene a plane is seen from a few scans: 1.63% of
// the entries and 2.97% of the (scan, 32-plane warp) groups are live on
// the 256-scan scene of chip_smoke.py.  So the kernel reads N of every
// entry, and the other nine CH channels and the three OFS channels only
// in a (scan, warp) group where some lane has N != 0, each byte once.
//
// Bound on the H100: bytes (N of every entry, 12 channels of the live
// ones, ~145 flops a live entry; chip_smoke.moments_bound).  Design: a
// block is 32 planes (x, one warp, coalesced along g) x 8 scan lanes (y),
// 256 threads; lane y sums the scans w = y (mod 8) in ascending order
// into 10 registers and the 8 lane sums merge in lane order in shared
// memory, the order of the dense loop this kernel replaced, so its
// outputs are bitwise those of that loop (no atomics: two runs give the
// same bits).  Per chunk of kChunk = 256 scans each thread stages the N of
// its (at most 32) scans with cp.async, all in flight, waits once, and
// forms a 32-bit live mask; the warp's OR of the masks lists the scans
// any of its planes is seen from, and only those are visited.  They are
// taken Batch<T>::k at a time (2 in float, 1 in double, chosen on the
// H100 where every warp is live; at 2 the double kernel spills under the
// register cap of kMinBlocks), the loads of a batch issued before its
// arithmetic.  In a visited scan every lane runs the same code, an empty
// lane (and a slot past the last live scan) loading zeros from kZero
// instead of its channels, which adds +-0.
// Where every warp is live this is the dense loop with N read first.  The
// stage takes kMomJ * 256 * sizeof(T) bytes (32 KB in float, 64 KB in
// double; W > 256 is taken in chunks of 256 scans) and holds the lane
// sums for the merge afterwards.  Any W >= 1 and G >= 1 are taken; the
// wrapper keeps the JAX contract that G is a multiple of 128.
//
// Build: one nvcc call with the other csrc/*.cu files (ops/_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMomBG = 32;                // planes per block (x)
constexpr int kMomBW = 8;                 // scan lanes per block (y)
constexpr int kMomT = kMomBG * kMomBW;    // threads per block
constexpr int kMomJ = 32;                 // scans per lane per chunk
constexpr int kChunk = kMomBW * kMomJ;    // scans per chunk (256)
constexpr int kOut = 10;                  // channels of CH and of out
constexpr int kMinBlocks = 3;             // blocks a SM holds (one wave)
constexpr unsigned kFull = 0xffffffffu;

// live scans visited together: their loads in flight at once
template <typename T>
struct Batch;
template <>
struct Batch<float> {
  static constexpr int k = 2;
};
template <>
struct Batch<double> {
  static constexpr int k = 1;
};

// what an empty entry's lane loads instead of its 12 channels
__device__ const float kZeroF[12] = {};
__device__ const double kZeroD[12] = {};
template <typename T>
__device__ __forceinline__ const T* zeros();
template <>
__device__ __forceinline__ const float* zeros<float>() {
  return kZeroF;
}
template <>
__device__ __forceinline__ const double* zeros<double>() {
  return kZeroD;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

// wait for this thread's cp.async copies (each thread reads back only
// its own slots, so no barrier is needed)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one (scan, plane) entry's channels: vech P (6), v (3), t' (3)
template <typename T>
struct Entry {
  T c[12];
};

// the entry of scan w at plane g (strides G), or zeros when !on
template <typename T>
__device__ __forceinline__ void load_entry(Entry<T>& e, const T* CH,
                                           const T* OFS, int64_t w,
                                           int64_t g, int64_t G, bool on) {
  const T* c = on ? CH + w * kOut * G + g : zeros<T>();
  const T* o = on ? OFS + w * 3 * G + g : zeros<T>() + 9;
  const int64_t s = on ? G : 1;
#pragma unroll
  for (int k = 0; k < 9; ++k) e.c[k] = c[k * s];
#pragma unroll
  for (int k = 0; k < 3; ++k) e.c[9 + k] = o[k * s];
}

// acc += T' C T'^T of one entry: the sum order and expressions of the
// dense loop (nvcc contracts them into FMAs the same way wherever it is
// inlined)
template <typename T>
__device__ __forceinline__ void add_entry(T acc[kOut],
                                          const T* __restrict__ rw,
                                          const Entry<T>& e, T n) {
  T r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = rw[k];
  const T pxx = e.c[0], pxy = e.c[1], pxz = e.c[2];
  const T pyy = e.c[3], pyz = e.c[4], pzz = e.c[5];
  const T vx = e.c[6], vy = e.c[7], vz = e.c[8];
  const T t[3] = {e.c[9], e.c[10], e.c[11]};
  const T P[3][3] = {{pxx, pxy, pxz}, {pxy, pyy, pyz}, {pxz, pyz, pzz}};
  // A = R P
  T A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      A[i][j] = r[3 * i + 0] * P[0][j] + r[3 * i + 1] * P[1][j] +
                r[3 * i + 2] * P[2][j];
  // M = A R^T (symmetric; the upper 6)
  T M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j)
      M[i][j] = A[i][0] * r[3 * j + 0] + A[i][1] * r[3 * j + 1] +
                A[i][2] * r[3 * j + 2];
  T gv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    gv[i] = r[3 * i + 0] * vx + r[3 * i + 1] * vy + r[3 * i + 2] * vz;
  acc[0] = acc[0] + M[0][0] + T(2) * gv[0] * t[0] + n * t[0] * t[0];
  acc[1] = acc[1] + M[0][1] + gv[0] * t[1] + gv[1] * t[0] + n * t[0] * t[1];
  acc[2] = acc[2] + M[0][2] + gv[0] * t[2] + gv[2] * t[0] + n * t[0] * t[2];
  acc[3] = acc[3] + M[1][1] + T(2) * gv[1] * t[1] + n * t[1] * t[1];
  acc[4] = acc[4] + M[1][2] + gv[1] * t[2] + gv[2] * t[1] + n * t[1] * t[2];
  acc[5] = acc[5] + M[2][2] + T(2) * gv[2] * t[2] + n * t[2] * t[2];
  acc[6] = acc[6] + gv[0] + n * t[0];
  acc[7] = acc[7] + gv[1] + n * t[1];
  acc[8] = acc[8] + gv[2] + n * t[2];
  acc[9] = acc[9] + n;
}

// dynamic shared memory: `rows` rows of kMomT scalars, a thread's slots
// strided by kMomT; rows >= max(scans a lane has in a chunk, kOut)
template <typename T>
__global__ void __launch_bounds__(kMomT, kMinBlocks)
    moments_kernel(const T* __restrict__ R9, const T* __restrict__ CH,
                   const T* __restrict__ OFS, T* __restrict__ out,
                   int64_t W, int64_t G) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  constexpr int kB = Batch<T>::k;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kMomBG + tx;
  const int64_t g0 = (int64_t)blockIdx.x * kMomBG;
  const int64_t g = g0 + tx;
  T* st = stage + tid;
  T acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = T(0);
  for (int64_t w0 = 0; w0 < W; w0 += kChunk) {
    // lane ty's scans of the chunk: w0 + ty + kMomBW j, j < nj
    const int64_t nw = (W - w0) < kChunk ? (W - w0) : kChunk;
    const int nj = (g < G && ty < nw)
                       ? (int)((nw - ty + kMomBW - 1) / kMomBW) : 0;
    const int64_t wl = w0 + ty;
    const T* n0 = CH + wl * kOut * G + 9 * G + g;
    for (int j = 0; j < nj; ++j)
      cp_async(st + j * kMomT, n0 + j * (int64_t)kMomBW * kOut * G);
    cp_async_wait_all();
    uint32_t lm = 0;
    for (int j = 0; j < nj; ++j)
      lm |= (st[j * kMomT] != T(0) ? 1u : 0u) << j;
    // the scans any lane of the warp is seen from, ascending
    uint32_t um = __reduce_or_sync(kFull, lm);
    while (um) {
      int js[kB];
      bool ok[kB];
#pragma unroll
      for (int s = 0; s < kB; ++s) {
        ok[s] = um != 0;
        js[s] = ok[s] ? __ffs(um) - 1 : 0;
        um &= um - 1;
      }
      Entry<T> e[kB];
      bool on[kB];
#pragma unroll
      for (int s = 0; s < kB; ++s) {
        on[s] = ok[s] && (lm >> js[s] & 1);
        load_entry(e[s], CH, OFS, wl + kMomBW * js[s], g, G, on[s]);
      }
#pragma unroll
      for (int s = 0; s < kB; ++s)
        add_entry(acc, R9 + (wl + kMomBW * js[s]) * 9, e[s],
                  on[s] ? st[js[s] * kMomT] : T(0));
    }
  }
  // every thread is done with its n: the stage takes the 8 lane sums of
  // each (channel, plane)
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kOut; ++k) stage[(ty * kOut + k) * kMomBG + tx] = acc[k];
  __syncthreads();
  // the 8 lane sums in lane order; consecutive threads write consecutive
  // planes of one channel
  for (int i = tid; i < kOut * kMomBG; i += kMomT) {
    const int k = i / kMomBG, x = i % kMomBG;
    if (g0 + x < G) {
      T s = stage[k * kMomBG + x];
      for (int yy = 1; yy < kMomBW; ++yy)
        s += stage[(yy * kOut + k) * kMomBG + x];
      out[k * G + g0 + x] = s;
    }
  }
}

template <typename T>
int launch_moments(const T* R9, const T* CH, const T* OFS, T* out,
                   int64_t W, int64_t G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the stage: a lane's scans of a chunk, at least the merge's kOut rows
  const int64_t wc = W < kChunk ? W : kChunk;
  const int64_t per_lane = (wc + kMomBW - 1) / kMomBW;
  const int64_t rows = per_lane > kOut ? per_lane : kOut;
  const size_t smem = (size_t)rows * kMomT * sizeof(T);
  // 64 KB in double passes 48 KB: allow it once per device
  static bool opted[64] = {};
  if (device < 64 && !opted[device]) {
    err = cudaFuncSetAttribute(moments_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kMomJ * kMomT * sizeof(T)));
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  const dim3 block(kMomBG, kMomBW);
  const dim3 grid((unsigned)((G + kMomBG - 1) / kMomBG));
  moments_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      R9, CH, OFS, out, W, G);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Selects the tensors' device, enqueues on the given stream (PyTorch's
// current stream), does not synchronise, returns cudaGetLastError().

extern "C" int balm_moments_f32(const float* R9, const float* CH,
                                const float* OFS, float* out, int64_t W,
                                int64_t G, int device, void* stream) {
  return launch_moments<float>(R9, CH, OFS, out, W, G, device, stream);
}

extern "C" int balm_moments_f64(const double* R9, const double* CH,
                                const double* OFS, double* out, int64_t W,
                                int64_t G, int device, void* stream) {
  return launch_moments<double>(R9, CH, OFS, out, W, G, device, stream);
}
