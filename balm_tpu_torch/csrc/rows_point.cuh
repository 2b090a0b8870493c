// Per-element math of the packed plane-factor evaluate, shared by the
// kernels of packed_kernels.cu (B1 `csum`, B2 `rows`) and hess_kernels.cu
// (B4, B5, B6).  Everything here is __host__ __device__, so the
// arithmetic can be rehearsed with a host compiler.

#pragma once

#include <stdint.h>

namespace {

// ---- per-element math (host and device) --------------------------------

__host__ __device__ __forceinline__ void cross3(const float* a,
                                                const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__host__ __device__ __forceinline__ float dot3(const float* a,
                                               const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Products and sums rounded one at a time, never contracted into an FMA,
// whatever the build's -fmad setting.
#ifdef __CUDA_ARCH__
#define MUL_RN(a, b) __fmul_rn((a), (b))
#define ADD_RN(a, b) __fadd_rn((a), (b))
#define SUB_RN(a, b) __fsub_rn((a), (b))
#else
#define MUL_RN(a, b) ((a) * (b))
#define ADD_RN(a, b) ((a) + (b))
#define SUB_RN(a, b) ((a) - (b))
#endif

// t = R b + t_w - c (the body offset composed into the pose, then the
// world shift by -c; balm_tpu/ops/pallas_evaluate.py:89-92), rounded
// step by step in the plain version's order: with t_w and c hundreds of
// metres from the origin the last two steps cancel most of the f32 bits,
// and an FMA here moves t by an ulp of t_w.
__host__ __device__ __forceinline__ void shifted_t(const float* r,
                                                   const float* b,
                                                   const float* c,
                                                   float* t) {
  for (int i = 0; i < 3; ++i)
    t[i] = SUB_RN(ADD_RN(ADD_RN(ADD_RN(MUL_RN(r[3 * i], b[0]),
                                       MUL_RN(r[3 * i + 1], b[1])),
                                MUL_RN(r[3 * i + 2], b[2])),
                         r[9 + i]),
                  c[i]);
}

// M = R P R^T for symmetric P given as vech (xx,xy,xz,yy,yz,zz)
__host__ __device__ __forceinline__ void rprt(const float* r,
                                              const float* pch,
                                              float M[3][3]) {
  const float P[3][3] = {{pch[0], pch[1], pch[2]},
                         {pch[1], pch[3], pch[4]},
                         {pch[2], pch[4], pch[5]}};
  float A[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      A[i][j] = r[3 * i] * P[0][j] + r[3 * i + 1] * P[1][j] +
                r[3 * i + 2] * P[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M[i][j] = A[i][0] * r[3 * j] + A[i][1] * r[3 * j + 1] +
                A[i][2] * r[3 * j + 2];
}

// One (scan, plane) of the rank-row assembly: the scalar form of
// _rows_channels_xla (balm_tpu/ops/pallas_evaluate.py:789-909).
// r: pose row (12), m: mom channels (10), c: center (3), ax: aux (17).
// Out: rows[j][k] (6 x 3), jv (6), D (36, row-major 6x6).
__host__ __device__ __forceinline__ void rows_point(
    const float* r, const float* m, const float* c, const float* ax,
    float rows[6][3], float jv[6], float D[36]) {
  const float* pch = m;
  const float b[3] = {m[6], m[7], m[8]};
  const float n = m[9];
  const float* u[3] = {ax, ax + 3, ax + 6};
  const float* vb = ax + 9;
  const float invN = ax[12], sqa = ax[13];
  const float sqk[2] = {ax[14], ax[15]};
  const float coew = ax[16];
  const float* u0 = u[0];

  float t[3];
  shifted_t(r, b, c, t);
  float RPRt[3][3];
  rprt(r, pch, RPRt);
  float d3[3], nt[3], X4[3];
  for (int i = 0; i < 3; ++i) {
    d3[i] = t[i] - vb[i];
    nt[i] = n * t[i];
    X4[i] = n * d3[i];
  }
  float X3[3][3];
  for (int a = 0; a < 3; ++a)
    for (int bb = 0; bb < 3; ++bb) X3[a][bb] = RPRt[a][bb] + nt[a] * d3[bb];

  float Xu[3][3], Xu3[3];
  for (int k = 0; k < 3; ++k) {
    for (int a = 0; a < 3; ++a)
      Xu[k][a] = X3[a][0] * u[k][0] + X3[a][1] * u[k][1] + X3[a][2] * u[k][2];
    Xu3[k] = dot3(X4, u[k]);
  }

  float a_rot[3], a_tr[3];
  cross3(nt, u0, a_rot);
  for (int i = 0; i < 3; ++i) a_tr[i] = n * u0[i];

  float jrot[3], jtr[3];
  cross3(Xu[0], u0, jrot);
  for (int i = 0; i < 3; ++i) {
    jrot[i] = 2.0f * invN * jrot[i];
    jtr[i] = 2.0f * invN * u0[i] * Xu3[0];
  }

  float g_rot[2][3], g_tr[2][3];
  for (int k = 1; k <= 2; ++k) {
    float g1r[3], g2r[3];
    cross3(Xu[0], u[k], g1r);
    cross3(Xu[k], u0, g2r);
    for (int i = 0; i < 3; ++i) {
      g_rot[k - 1][i] = invN * (g1r[i] + g2r[i]);
      g_tr[k - 1][i] = invN * (u[k][i] * Xu3[0] + u0[i] * Xu3[k]);
    }
  }

  // block-diagonal correction (derivation at pallas_evaluate.py:284-440)
  float Y[3][3];
  for (int a = 0; a < 3; ++a)
    for (int bb = 0; bb < 3; ++bb) Y[a][bb] = X3[a][bb] + nt[a] * vb[bb];
  float B1r[3][3];  // B1r[a][j] = -(u0 x Y[:, j])[a]
  for (int j = 0; j < 3; ++j) {
    const float col[3] = {Y[0][j], Y[1][j], Y[2][j]};
    float cx[3];
    cross3(u0, col, cx);
    for (int a = 0; a < 3; ++a) B1r[a][j] = -cx[a];
  }
  float TL[3][3];
  for (int a = 0; a < 3; ++a) {
    float cx[3];
    cross3(u0, B1r[a], cx);
    for (int bb = 0; bb < 3; ++bb) TL[a][bb] = -cx[bb];
  }
  const float* y = Xu[0];
  const float ydu = dot3(y, u0);
  const float two_invN = 2.0f * invN;
  float Dtl[3][3], Dtr[3][3], Dbr[3][3], Dbl[3][3];
  for (int a = 0; a < 3; ++a)
    for (int bb = 0; bb < 3; ++bb) {
      Dtl[a][bb] = invN * (u0[a] * y[bb] + y[a] * u0[bb]) +
                   two_invN * TL[a][bb];
      Dtr[a][bb] = two_invN * a_rot[a] * u0[bb];
      Dbr[a][bb] = two_invN * n * u0[a] * u0[bb];
    }
  for (int a = 0; a < 3; ++a) Dtl[a][a] = Dtl[a][a] - two_invN * ydu;
  for (int a = 0; a < 3; ++a)
    for (int bb = 0; bb < 3; ++bb) Dbl[a][bb] = Dtr[bb][a];

  // centering adjoint on the twist vectors: (rot, tr) -> (rot + c x tr, tr)
  {
    float cx[3];
    cross3(c, a_tr, cx);
    for (int i = 0; i < 3; ++i) a_rot[i] += cx[i];
    cross3(c, jtr, cx);
    for (int i = 0; i < 3; ++i) jrot[i] += cx[i];
    for (int k = 0; k < 2; ++k) {
      cross3(c, g_tr[k], cx);
      for (int i = 0; i < 3; ++i) g_rot[k][i] += cx[i];
    }
  }

  // ... and on the diagonal blocks (rows_pluscross / cols_pluscross)
  float A2[3][3], C2[3][3];
  for (int a = 0; a < 3; ++a) {
    float cx[3], cy[3];
    cross3(c, Dtr[a], cx);
    cross3(c, Dbr[a], cy);
    for (int bb = 0; bb < 3; ++bb) {
      A2[a][bb] = Dtl[a][bb] + cx[bb];
      C2[a][bb] = Dbl[a][bb] + cy[bb];
    }
  }
  float Dtl2[3][3], Dtr2[3][3];
  for (int bb = 0; bb < 3; ++bb) {
    const float colC[3] = {C2[0][bb], C2[1][bb], C2[2][bb]};
    const float colB[3] = {Dbr[0][bb], Dbr[1][bb], Dbr[2][bb]};
    float cx[3], cy[3];
    cross3(c, colC, cx);
    cross3(c, colB, cy);
    for (int a = 0; a < 3; ++a) {
      Dtl2[a][bb] = A2[a][bb] + cx[a];
      Dtr2[a][bb] = Dtr[a][bb] + cy[a];
    }
  }
  const float gdc = dot3(jtr, c);
  for (int a = 0; a < 3; ++a)
    for (int bb = 0; bb < 3; ++bb)
      Dtl2[a][bb] = Dtl2[a][bb] + 0.5f * (jtr[a] * c[bb] + c[a] * jtr[bb]);
  for (int a = 0; a < 3; ++a) Dtl2[a][a] = Dtl2[a][a] - gdc;

  for (int j = 0; j < 3; ++j) {
    rows[j][0] = sqa * a_rot[j];
    rows[j + 3][0] = sqa * a_tr[j];
    rows[j][1] = sqk[0] * g_rot[0][j];
    rows[j + 3][1] = sqk[0] * g_tr[0][j];
    rows[j][2] = sqk[1] * g_rot[1][j];
    rows[j + 3][2] = sqk[1] * g_tr[1][j];
    jv[j] = coew * jrot[j];
    jv[j + 3] = coew * jtr[j];
  }
  for (int a = 0; a < 3; ++a)
    for (int bb = 0; bb < 3; ++bb) {
      D[a * 6 + bb] = coew * Dtl2[a][bb];
      D[a * 6 + bb + 3] = coew * Dtr2[a][bb];
      D[(a + 3) * 6 + bb] = coew * C2[a][bb];
      D[(a + 3) * 6 + bb + 3] = coew * Dbr[a][bb];
    }
}

}  // namespace
