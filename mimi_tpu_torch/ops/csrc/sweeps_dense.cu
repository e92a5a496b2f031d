// Dense-table quadrature sweeps of the implicit step, for sm_90a.
//
// Three kernels, each replacing one Pallas TPU kernel of
// mimi_tpu/ops/sweeps.py in its dense-table branch (dN (27,3,64,E),
// N (27,64,E), w det J (64,E) streamed from device memory), with the
// 45-plane symmetric tangent (c_storage="sym"):
//   mimi_residual_dense  <- make_residual_sweep (dense, inviscid)   residual only
//   mimi_assemble_dense  <- make_assemble_sweep (dense, "sym")      residual + 45 tangent planes
//   mimi_matvec_dense    <- make_matvec_sweep ("sym")              y = J w
// The plain torch versions of the same functions are in ops/sweeps.py
// (residual_dense_plain, assemble_dense_plain, matvec_dense_plain).
//
// The residual and the assemble are templated on the material (its first
// Piola stress and closed-form dP/dF as device functions) and on the
// tangent storage; the matvec on the storage.  Instantiated: the
// compressible Ogden neo-Hookean material with the symmetric storage,
// plane (a, b), a <= b, of tri_index_map(9) holding (C_ab + C_ba) / 2
// with C_ab = dP_a / dF_b, a = 3 c + d.
//
// Design: one thread per element, 64 elements per block, looping over the
// element's 64 quadrature points.  The batch-last layout puts neighbouring
// elements on neighbouring addresses, so every table read and tangent
// write of a warp coalesces.  Each thread stages its element's dof values
// (81 floats per field) in its own column of shared memory, which keeps
// them out of the register file; its 81 output sums stay in registers, so
// no thread touches another's data (no barrier, no atomics).  The scatter
// reads each point's dN and N rows a second time, from L1.
//
// What bounds them on the H100: bytes.  Per call at E = 109,744 the
// residual streams dN 2.28 GB, N 0.76 GB and w det J 0.03 GB plus the
// element fields, 3.17 GB, about 0.95 ms at 3.35 TB/s; the assemble writes
// the 45 planes as well (1.26 GB, 4.43 GB in all, ~1.32 ms); the matvec
// reads the planes instead (4.40 GB, ~1.31 ms).  Per point they do a few
// hundred flops against ~450 bytes, under one flop per byte.
//
// Rounding: the deformation gradient and the neo-Hookean stress are
// formed with single-rounding intrinsics (no fused multiply-add), in the
// order of the plain torch version's separate operations, so F and P
// agree with it to the bit; the stress mu / J (B - I) + lambda (J - 1) I
// cancels near F = I, and an FMA there would differ from the plain
// version by an ulp of mu, a relative 1e-4 of P at strains of 1e-3.
// No --use_fast_math: divisions and reciprocals are IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int ND = 27;  // dofs per element (p = 2)
constexpr int NQ = 64;  // quadrature points per element
constexpr int NW = 3 * ND;
constexpr int BLOCK = 64;

}  // namespace

struct NeoHookeanParams {
  float mu, lam, rho;
};

namespace {

// single-rounding IEEE operations the compiler may not contract
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }

// this thread's element dof values (3, ND, E) into its shared column
__device__ __forceinline__ void stage(const float* __restrict__ g, float (*s)[BLOCK],
                                      long long e, long long E) {
#pragma unroll 9
  for (int k = 0; k < NW; ++k) s[k][threadIdx.x] = __ldg(g + (long long)k * E + e);
}

// G[g][f] = sum_n dN[n][f](q) w[g][n], summed in n order without FMA
__device__ __forceinline__ void grad_q(const float* __restrict__ dN, float (*w)[BLOCK],
                                       long long qe, long long QE, float G[3][3]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int f = 0; f < 3; ++f) G[g][f] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float d[3];
#pragma unroll
    for (int f = 0; f < 3; ++f) d[f] = __ldg(dN + (long long)(n * 3 + f) * QE + qe);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float wv = w[g * ND + n][threadIdx.x];
#pragma unroll
      for (int f = 0; f < 3; ++f) G[g][f] = add(G[g][f], mul(d[f], wv));
    }
  }
}

// v[c] = sum_n N[n](q) w[c][n]
__device__ __forceinline__ void value_q(const float* __restrict__ N, float (*w)[BLOCK],
                                        long long qe, long long QE, float v[3]) {
  v[0] = v[1] = v[2] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float Nn = __ldg(N + (long long)n * QE + qe);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] += Nn * w[c * ND + n][threadIdx.x];
  }
}

// acc[c][n] += wq (sum_d dN[n][d] X[c][d] + N[n] m[c])
__device__ __forceinline__ void scatter_q(float (&acc)[3][ND], const float* __restrict__ dN,
                                          const float* __restrict__ N, long long qe,
                                          long long QE, float wq, const float X[3][3],
                                          const float m[3]) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float d0 = __ldg(dN + (long long)(n * 3 + 0) * QE + qe);
    const float d1 = __ldg(dN + (long long)(n * 3 + 1) * QE + qe);
    const float d2 = __ldg(dN + (long long)(n * 3 + 2) * QE + qe);
    const float Nn = __ldg(N + (long long)n * QE + qe);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[c][n] += wq * (d0 * X[c][0] + d1 * X[c][1] + d2 * X[c][2] + Nn * m[c]);
  }
}

// det and adjugate inverse with the operation order of fem/soa.py
__device__ __forceinline__ float det3(const float A[3][3]) {
  const float m1 = mul(A[0][0], sub(mul(A[1][1], A[2][2]), mul(A[1][2], A[2][1])));
  const float m2 = mul(A[0][1], sub(mul(A[1][0], A[2][2]), mul(A[1][2], A[2][0])));
  const float m3 = mul(A[0][2], sub(mul(A[1][0], A[2][1]), mul(A[1][1], A[2][0])));
  return add(sub(m1, m2), m3);
}

__device__ __forceinline__ void inv3(const float A[3][3], float R[3][3]) {
  const float id = rcp(det3(A));  // 1.0 / det: torch takes the reciprocal
#define COF(i1, j1, i2, j2) mul(sub(mul(A[i1][j1], A[i2][j2]), mul(A[i1][j2], A[i2][j1])), id)
  R[0][0] = COF(1, 1, 2, 2);
  R[0][1] = COF(0, 2, 2, 1);
  R[0][2] = COF(0, 1, 1, 2);
  R[1][0] = COF(1, 2, 2, 0);
  R[1][1] = COF(0, 0, 2, 2);
  R[1][2] = COF(0, 2, 1, 0);
  R[2][0] = COF(1, 0, 2, 1);
  R[2][1] = COF(0, 1, 2, 0);
  R[2][2] = COF(0, 0, 1, 1);
#undef COF
}

// (A B^T)_ij = (A_i0 B_j0 + A_i1 B_j1) + A_i2 B_j2
__device__ __forceinline__ float dot_nt(const float A[3][3], const float B[3][3], int i,
                                        int j) {
  return add(add(mul(A[i][0], B[j][0]), mul(A[i][1], B[j][1])), mul(A[i][2], B[j][2]));
}

// ---- materials -------------------------------------------------------------

// Compressible Ogden neo-Hookean (materials/__init__.py
// CompressibleOgdenNeoHookean): sigma = mu/J (B - I) + lambda (J - 1) I,
// P = J sigma F^-T; dP/dF in closed form,
//   C_cdgf = mu d_cg d_df + k1 G_cd G_gf - k2 G_cf G_gd,
//   G = F^-T, k1 = lambda (2J - 1) J, k2 = lambda J (J - 1) - mu.
struct NeoHookean {
  float mu, lam;

  struct Tangent {
    float G[3][3], k1, k2, mu;
    __device__ __forceinline__ float operator()(int a, int b) const {
      const int c = a / 3, d = a % 3, g = b / 3, f = b % 3;
      return (c == g && d == f ? mu : 0.f) + k1 * G[c][d] * G[g][f] - k2 * G[c][f] * G[g][d];
    }
  };

  // P with the operation order of pk1_soa (sigma first, then J sigma F^-T)
  __device__ __forceinline__ void pk1(const float F[3][3], float P[3][3]) const {
    const float J = det3(F);
    const float muJ = mul(rcp(J), mu);  // mu / J: torch multiplies by 1 / J
    const float diag = add(-muJ, mul(lam, sub(J, 1.f)));
    float sig[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float x = mul(muJ, dot_nt(F, F, i, j));
        sig[i][j] = i == j ? add(x, diag) : x;
      }
    float fi[3][3];
    inv3(F, fi);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = mul(J, dot_nt(sig, fi, i, j));
  }

  __device__ __forceinline__ Tangent tangent(const float F[3][3]) const {
    Tangent t;
    const float J = det3(F);
    float fi[3][3];
    inv3(F, fi);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) t.G[c][d] = fi[d][c];
    t.k1 = lam * (2.f * J - 1.f) * J;
    t.k2 = lam * J * (J - 1.f) - mu;
    t.mu = mu;
    return t;
  }
};

// ---- tangent storages ------------------------------------------------------

// upper triangle of the 9 x 9 dP/dF, row-major (ops/sweeps.py tri_index_map)
struct SymStorage {
  static constexpr int kPlanes = 45;
  __host__ __device__ static constexpr int plane(int a, int b) {
    const int lo = a < b ? a : b, hi = a < b ? b : a;
    return lo * 9 - lo * (lo - 1) / 2 + (hi - lo);
  }
  // the stored planes of a major-symmetric tangent: (C_ab + C_ba) / 2,
  // halves in the order the reference adds them (the transposed entry
  // first)
  template <class T>
  __device__ __forceinline__ static void store(float* __restrict__ cout, long long qe,
                                               long long QE, const T& C) {
    int k = 0;
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int b = a; b < 9; ++b, ++k)
        cout[k * QE + qe] = a == b ? C(a, a) : 0.5f * C(b, a) + 0.5f * C(a, b);
  }
};

// ---- kernels ---------------------------------------------------------------

template <class Mat, class Store, bool TANGENT>
__global__ void __launch_bounds__(BLOCK)
    residual_kernel(const float* __restrict__ u_el, const float* __restrict__ a_el,
                    const float* __restrict__ dN, const float* __restrict__ N,
                    const float* __restrict__ wq, float* __restrict__ out,
                    float* __restrict__ cout, Mat mat, float rho, long long E) {
  __shared__ float su[NW][BLOCK];
  __shared__ float sa[NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;  // threads share nothing: no barrier below
  stage(u_el, su, e, E);
  stage(a_el, sa, e, E);
  float acc[3][ND];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float F[3][3];
    grad_q(dN, su, qe, QE, F);
    F[0][0] = add(F[0][0], 1.f);
    F[1][1] = add(F[1][1], 1.f);
    F[2][2] = add(F[2][2], 1.f);
    float P[3][3];
    mat.pk1(F, P);
    if (TANGENT) Store::store(cout, qe, QE, mat.tangent(F));
    float av[3];
    value_q(N, sa, qe, QE, av);
    const float m[3] = {rho * av[0], rho * av[1], rho * av[2]};
    scatter_q(acc, dN, N, qe, QE, __ldg(wq + qe), P, m);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

template <class Store>
__global__ void __launch_bounds__(BLOCK)
    matvec_kernel(const float* __restrict__ w_el, const float* __restrict__ dN,
                  const float* __restrict__ N, const float* __restrict__ wq,
                  const float* __restrict__ cs, float* __restrict__ out, float rho,
                  float fac0, long long E) {
  __shared__ float sw[NW][BLOCK];
  const long long e = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (e >= E) return;
  stage(w_el, sw, e, E);
  float acc[3][ND];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[c][n] = 0.f;
  const long long QE = (long long)NQ * E;
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const long long qe = (long long)q * E + e;
    float dF[3][3], v[3];
    grad_q(dN, sw, qe, QE, dF);
    value_q(N, sw, qe, QE, v);
    float C[Store::kPlanes];
#pragma unroll
    for (int k = 0; k < Store::kPlanes; ++k) C[k] = __ldg(cs + k * QE + qe);
    // dP_a = fac0 sum_k C(a, k) dF_k, k in order (_tangent_apply)
    float dP[3][3];
#pragma unroll
    for (int a = 0; a < 9; ++a) {
      float s = C[Store::plane(a, 0)] * dF[0][0];
#pragma unroll
      for (int k = 1; k < 9; ++k) s += C[Store::plane(a, k)] * dF[k / 3][k % 3];
      dP[a / 3][a % 3] = fac0 * s;
    }
    const float m[3] = {rho * v[0], rho * v[1], rho * v[2]};
    scatter_q(acc, dN, N, qe, QE, __ldg(wq + qe), dP, m);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < ND; ++n) out[(long long)(c * ND + n) * E + e] = acc[c][n];
}

inline unsigned grid_for(long long E) { return (unsigned)((E + BLOCK - 1) / BLOCK); }

}  // namespace

// C entry points: the neo-Hookean material with the symmetric storage.
// Each returns the launch's cudaGetLastError().
extern "C" {

int mimi_residual_dense(const float* u_el, const float* a_el, const float* dN,
                        const float* N, const float* wq, float* out, NeoHookeanParams p,
                        long long E, void* stream) {
  if (E <= 0) return 0;
  residual_kernel<NeoHookean, SymStorage, false>
      <<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
          u_el, a_el, dN, N, wq, out, nullptr, NeoHookean{p.mu, p.lam}, p.rho, E);
  return (int)cudaGetLastError();
}

int mimi_assemble_dense(const float* u_el, const float* a_el, const float* dN,
                        const float* N, const float* wq, float* out, float* cout,
                        NeoHookeanParams p, long long E, void* stream) {
  if (E <= 0) return 0;
  residual_kernel<NeoHookean, SymStorage, true>
      <<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
          u_el, a_el, dN, N, wq, out, cout, NeoHookean{p.mu, p.lam}, p.rho, E);
  return (int)cudaGetLastError();
}

int mimi_matvec_dense(const float* w_el, const float* dN, const float* N, const float* wq,
                      const float* cs, float* out, float rho, float fac0, long long E,
                      void* stream) {
  if (E <= 0) return 0;
  matvec_kernel<SymStorage><<<grid_for(E), BLOCK, 0, (cudaStream_t)stream>>>(
      w_el, dN, N, wq, cs, out, rho, fac0, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
