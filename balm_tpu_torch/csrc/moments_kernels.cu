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
//   CH  (W, 10, G)  body moment channels
//   OFS (W, 3, G)   effective translations t'_gw
// -> out (10, G).  The plane axis is contiguous, so a warp of 32 planes
// reads every channel coalesced.  The arithmetic is the Pallas kernel's:
// A = R P, M = A R^T (upper 6), Rv = R v, and the t terms.  t' comes in
// as an input (formed in the glue as on the path without the kernel), so
// its cancellation R b + t - c is not re-rounded here.  Templated on the
// scalar type: float on the card's f32 path, double for the f64 path.
//
// Bound on the H100: bytes.  Each (scan, plane) reads 13 values against
// ~70 flops: (13 W G + 10 G + 9 W) elements, 153.8 MB in f32 at W=256,
// G=11520, 0.046 ms at 3.35 TB/s.  Design: one thread per plane puts
// only 11,520 threads (under one wave) on the card, so a block is 32
// planes (one warp, coalesced along g) x 8 scan lanes, 256 threads; each
// lane walks every 8th scan, keeping the 10 sums in registers, and the 8
// lane sums are combined in a fixed order in shared memory (no atomics:
// two runs give the same bits).  Any W >= 1 and G >= 1 are taken; the
// wrapper keeps the JAX contract that G is a multiple of 128.
//
// Build: one nvcc call with the other csrc/*.cu files (ops/_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMomBG = 32;  // planes per block (x)
constexpr int kMomBW = 8;   // scan lanes per block (y)

template <typename T>
__global__ void __launch_bounds__(kMomBG * kMomBW)
    moments_kernel(const T* __restrict__ R9, const T* __restrict__ CH,
                   const T* __restrict__ OFS, T* __restrict__ out,
                   int64_t W, int64_t G) {
  __shared__ T red[kMomBW][10][kMomBG];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t g0 = (int64_t)blockIdx.x * kMomBG;
  const int64_t g = g0 + tx;
  T acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = T(0);
  if (g < G) {
    for (int64_t w = ty; w < W; w += kMomBW) {
      T r[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) r[k] = R9[w * 9 + k];
      const T* ch = CH + w * 10 * G + g;
      const T* o = OFS + w * 3 * G + g;
      const T pxx = ch[0], pxy = ch[G], pxz = ch[2 * G];
      const T pyy = ch[3 * G], pyz = ch[4 * G], pzz = ch[5 * G];
      const T vx = ch[6 * G], vy = ch[7 * G], vz = ch[8 * G];
      const T n = ch[9 * G];
      const T t[3] = {o[0], o[G], o[2 * G]};
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
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) red[ty][k][tx] = acc[k];
  __syncthreads();
  // the 8 lane sums of each (channel, plane), in lane order; consecutive
  // threads write consecutive planes of one channel
  for (int i = ty * kMomBG + tx; i < 10 * kMomBG; i += kMomBG * kMomBW) {
    const int k = i / kMomBG, x = i % kMomBG;
    if (g0 + x < G) {
      T s = red[0][k][x];
      for (int yy = 1; yy < kMomBW; ++yy) s += red[yy][k][x];
      out[k * G + g0 + x] = s;
    }
  }
}

template <typename T>
int launch_moments(const T* R9, const T* CH, const T* OFS, T* out,
                   int64_t W, int64_t G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kMomBG, kMomBW);
  const dim3 grid((unsigned)((G + kMomBG - 1) / kMomBG));
  moments_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(R9, CH, OFS,
                                                              out, W, G);
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
