// Hyperelastic materials and tangent storages shared by the CUDA sweeps
// (sweeps_sf.cu, sweeps_sf_finite.cu, sweeps_dense.cu, sweeps_dense_j2.cu,
// sweeps_dense_finite.cu, fused_neohookean.cu), for sm_90a.
//
// A material is a struct templated on the dimension DIM (2 or 3) with its
// first Piola stress `pk1(F, P)` and its closed-form dP/dF as
// `tangent(F)`, an object whose operator()(a, b) returns
// C_ab = dP_a / dF_b with a = DIM c + d (no automatic differentiation on
// the device).  A storage names the planes of the
// per-point tangent block, writes them (`store`) and applies them to a
// displacement gradient (`apply`).  The kernels take both as template
// parameters.
//
// Rounding: the stresses are formed with single-rounding intrinsics (no
// fused multiply-add), in the order of the plain torch versions' separate
// operations (materials/__init__.py pk1_soa), so that P agrees with them to
// the bit given the same F.  mu (F - F^-T) and mu/J (B - I) cancel near
// F = I; an FMA there would differ from the plain version by an ulp of mu,
// a relative 1e-4 of P at strains of 1e-3.  No --use_fast_math: divisions
// and reciprocals are IEEE.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

// Lame constants and density of a hyperelastic material (the C entry
// points' parameter block; mirrored by ops/sweeps.py _HyperParams)
struct HyperelasticParams {
  float mu, lam, rho;
};

namespace {

// single-rounding IEEE operations the compiler may not contract, and the
// 2 x 2 and 3 x 3 algebra of fem/soa.py in its operation order
namespace rn {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }

__device__ __forceinline__ float det(const float A[2][2]) {
  return sub(mul(A[0][0], A[1][1]), mul(A[0][1], A[1][0]));
}

__device__ __forceinline__ float det(const float A[3][3]) {
  const float m1 = mul(A[0][0], sub(mul(A[1][1], A[2][2]), mul(A[1][2], A[2][1])));
  const float m2 = mul(A[0][1], sub(mul(A[1][0], A[2][2]), mul(A[1][2], A[2][0])));
  const float m3 = mul(A[0][2], sub(mul(A[1][0], A[2][1]), mul(A[1][1], A[2][0])));
  return add(sub(m1, m2), m3);
}

__device__ __forceinline__ float det3(const float A[3][3]) { return det(A); }

// 2 x 2: the adjugate divided by det, as fem/soa.py inv divides
__device__ __forceinline__ void inv(const float A[2][2], float R[2][2]) {
  const float d = det(A);
  R[0][0] = div(A[1][1], d);
  R[0][1] = div(-A[0][1], d);
  R[1][0] = div(-A[1][0], d);
  R[1][1] = div(A[0][0], d);
}

// 3 x 3: the cofactor formulas of fem/soa.py inv, times 1 / det
__device__ __forceinline__ void inv(const float A[3][3], float R[3][3]) {
  const float id = rcp(det(A));  // 1.0 / det: torch takes the reciprocal
#define MIMI_COF(i1, j1, i2, j2) \
  mul(sub(mul(A[i1][j1], A[i2][j2]), mul(A[i1][j2], A[i2][j1])), id)
  R[0][0] = MIMI_COF(1, 1, 2, 2);
  R[0][1] = MIMI_COF(0, 2, 2, 1);
  R[0][2] = MIMI_COF(0, 1, 1, 2);
  R[1][0] = MIMI_COF(1, 2, 2, 0);
  R[1][1] = MIMI_COF(0, 0, 2, 2);
  R[1][2] = MIMI_COF(0, 2, 1, 0);
  R[2][0] = MIMI_COF(1, 0, 2, 1);
  R[2][1] = MIMI_COF(0, 1, 2, 0);
  R[2][2] = MIMI_COF(0, 0, 1, 1);
#undef MIMI_COF
}

__device__ __forceinline__ void inv3(const float A[3][3], float R[3][3]) { inv(A, R); }

// (A B^T)_ij = ((A_i0 B_j0 + A_i1 B_j1) + A_i2 B_j2): Python's sum order
template <int D>
__device__ __forceinline__ float dot_nt(const float A[D][D], const float B[D][D], int i,
                                        int j) {
  float s = mul(A[i][0], B[j][0]);
#pragma unroll
  for (int k = 1; k < D; ++k) s = add(s, mul(A[i][k], B[j][k]));
  return s;
}

// (A^T B)_ij = ((A_0i B_0j + A_1i B_1j) + A_2i B_2j)
template <int D>
__device__ __forceinline__ float dot_tn(const float A[D][D], const float B[D][D], int i,
                                        int j) {
  float s = mul(A[0][i], B[0][j]);
#pragma unroll
  for (int k = 1; k < D; ++k) s = add(s, mul(A[k][i], B[k][j]));
  return s;
}

// (A B)_ij = ((A_i0 B_0j + A_i1 B_1j) + A_i2 B_2j)
template <int D>
__device__ __forceinline__ float dot_nn(const float A[D][D], const float B[D][D], int i,
                                        int j) {
  float s = mul(A[i][0], B[0][j]);
#pragma unroll
  for (int k = 1; k < D; ++k) s = add(s, mul(A[i][k], B[k][j]));
  return s;
}

}  // namespace rn

// ---- materials -------------------------------------------------------------

// Compressible Ogden neo-Hookean (materials/__init__.py
// CompressibleOgdenNeoHookean) on DIM x DIM tensors:
// sigma = mu/J (B - I) + lambda (J - 1) I, P = J sigma F^-T; dP/dF in
// closed form (the same in 2D and 3D),
//   C_cdgf = mu d_cg d_df + k1 G_cd G_gf - k2 G_cf G_gd,
//   G = F^-T, k1 = lambda (2J - 1) J, k2 = lambda J (J - 1) - mu.
template <int DIM>
struct NeoHookean {
  static constexpr int kDim = DIM;
  float mu, lam;

  struct Tangent {
    float G[DIM][DIM], k1, k2, mu;
    __device__ __forceinline__ float operator()(int a, int b) const {
      const int c = a / DIM, d = a % DIM, g = b / DIM, f = b % DIM;
      return (c == g && d == f ? mu : 0.f) + k1 * G[c][d] * G[g][f] - k2 * G[c][f] * G[g][d];
    }
  };

  // P with the operation order of pk1_soa (sigma first, then J sigma F^-T)
  __device__ __forceinline__ void pk1(const float F[DIM][DIM], float P[DIM][DIM]) const {
    using namespace rn;
    const float J = det(F);
    const float muJ = mul(rcp(J), mu);  // mu / J: torch multiplies by 1 / J
    const float diag = add(-muJ, mul(lam, sub(J, 1.f)));
    float sig[DIM][DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        const float x = mul(muJ, dot_nt<DIM>(F, F, i, j));
        sig[i][j] = i == j ? add(x, diag) : x;
      }
    float fi[DIM][DIM];
    inv(F, fi);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) P[i][j] = mul(J, dot_nt<DIM>(sig, fi, i, j));
  }

  __device__ __forceinline__ Tangent tangent(const float F[DIM][DIM]) const {
    Tangent t;
    const float J = rn::det(F);
    float fi[DIM][DIM];
    rn::inv(F, fi);
#pragma unroll
    for (int c = 0; c < DIM; ++c)
#pragma unroll
      for (int d = 0; d < DIM; ++d) t.G[c][d] = fi[d][c];
    t.k1 = lam * (2.f * J - 1.f) * J;
    t.k2 = lam * J * (J - 1.f) - mu;
    t.mu = mu;
    return t;
  }
};

// St. Venant-Kirchhoff (materials/__init__.py StVenantKirchhoff) on
// DIM x DIM tensors: E = (F^T F - I) / 2, S = lambda tr(E) I + 2 mu E,
// P = F S; dP/dF in closed form,
//   C_cdgf = d_cg S_fd + lambda F_cd F_gf + mu (F_cf F_gd + B_cg d_df),
//   B = F F^T.
template <int DIM>
struct StVK {
  static constexpr int kDim = DIM;
  float mu, lam;

  struct Tangent {
    float F[DIM][DIM], S[DIM][DIM], B[DIM][DIM], mu, lam;
    __device__ __forceinline__ float operator()(int a, int b) const {
      const int c = a / DIM, d = a % DIM, g = b / DIM, f = b % DIM;
      return (c == g ? S[f][d] : 0.f) + lam * F[c][d] * F[g][f] +
             mu * (F[c][f] * F[g][d] + (d == f ? B[c][g] : 0.f));
    }
  };

  // S with the operation order of pk1_soa
  __device__ __forceinline__ void second_pk(const float F[DIM][DIM], float S[DIM][DIM]) const {
    using namespace rn;
    float E[DIM][DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        const float c = dot_tn<DIM>(F, F, i, j);
        E[i][j] = mul(0.5f, i == j ? add(c, -1.f) : c);
      }
    float tr = E[0][0];
#pragma unroll
    for (int i = 1; i < DIM; ++i) tr = add(tr, E[i][i]);
    const float diag = mul(lam, tr);
    const float mu2 = 2.f * mu;  // exact
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        const float x = mul(mu2, E[i][j]);
        S[i][j] = i == j ? add(x, diag) : x;
      }
  }

  __device__ __forceinline__ void pk1(const float F[DIM][DIM], float P[DIM][DIM]) const {
    float S[DIM][DIM];
    second_pk(F, S);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) P[i][j] = rn::dot_nn<DIM>(F, S, i, j);
  }

  __device__ __forceinline__ Tangent tangent(const float F[DIM][DIM]) const {
    Tangent t;
    second_pk(F, t.S);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        t.F[i][j] = F[i][j];
        float b = F[i][0] * F[j][0];
#pragma unroll
        for (int k = 1; k < DIM; ++k) b += F[i][k] * F[j][k];
        t.B[i][j] = b;
      }
    t.mu = mu;
    t.lam = lam;
    return t;
  }
};

// a stateless hyperelastic material of the above on the sweep kernels'
// material interface: `eval` forms P at a point and, with TANGENT, the
// point's closed-form tangent, which SymStorage<kDim> reads entry by entry
// and FullStorage<kDim> column by column (`column`)
template <class H>
struct Hyper {
  static constexpr int kDim = H::kDim;
  H h;
  using Point = typename H::Tangent;
  template <bool TANGENT>
  __device__ __forceinline__ void eval(const float F[kDim][kDim], long long, long long,
                                       float P[kDim][kDim], Point& pt) const {
    h.pk1(F, P);
    if (TANGENT) pt = h.tangent(F);
  }
  // column b of dP/dF: C_ab for every a, unsymmetrized
  __device__ __forceinline__ void column(const Point& pt, long long, long long, int b,
                                         float col[kDim * kDim]) const {
#pragma unroll
    for (int a = 0; a < kDim * kDim; ++a) col[a] = pt(a, b);
  }
};

// whether a material's tangent is dealt over the warps as forward-mode
// (point, column) passes after the round's float passes (kDealtTangent:
// finite.cuh FiniteMat; dense_common.cuh dense_slot_kernel, sf_common.cuh
// sf_dealt_kernel), rather than stored in the float pass
template <class Mat, class = void>
struct dealt_tangent : std::false_type {};
template <class Mat>
struct dealt_tangent<Mat, std::void_t<decltype(Mat::kDealtTangent)>>
    : std::integral_constant<bool, Mat::kDealtTangent> {};

// Whether a sweep kernel's launch with the material runs at all: always,
// but for J2Log's second launch of a sweep (finite.cuh), which runs only
// where the first found a point out of the log series' fast range
template <class Mat>
__device__ __forceinline__ bool launch_runs(const Mat&) {
  return true;
}

// ---- tangent-block element types -------------------------------------------

// float, or bfloat16 rounded to nearest even
__device__ __forceinline__ void store_c(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_c(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float load_c(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_c(const __nv_bfloat16* p) {
  // a bfloat16 is the upper half of a float: widening is exact
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(((unsigned)bits) << 16);
}

// ---- tangent storages ------------------------------------------------------

// upper triangle of the D2 x D2 dP/dF, D2 = DIM^2, row-major (ops/sweeps.py
// tri_index_map(D2)): 45 planes in 3D, 10 in 2D
template <int DIM>
struct SymStorage {
  static constexpr int D2 = DIM * DIM;
  static constexpr int kPlanes = D2 * (D2 + 1) / 2;
  __host__ __device__ static constexpr int plane(int a, int b) {
    const int lo = a < b ? a : b, hi = a < b ? b : a;
    return lo * D2 - lo * (lo - 1) / 2 + (hi - lo);
  }
  // the stored planes of a major-symmetric tangent: (C_ab + C_ba) / 2,
  // halves in the order the reference adds them (the transposed entry
  // first); the material is not needed (the signature is every storage's)
  template <class Mat, class T, typename CT>
  __device__ __forceinline__ static void store(CT* __restrict__ cout, long long qe,
                                               long long QE, const Mat&, const T& C) {
    int k = 0;
#pragma unroll
    for (int a = 0; a < D2; ++a)
#pragma unroll
      for (int b = a; b < D2; ++b, ++k)
        store_c(cout + k * QE + qe, a == b ? C(a, a) : 0.5f * C(b, a) + 0.5f * C(a, b));
  }
  // dP_a = fac0 sum_k C(a, k) dF_k, k in order (ops/sweeps.py
  // tangent_apply_sym)
  template <typename CT>
  __device__ __forceinline__ static void apply(const CT* __restrict__ cs, long long qe,
                                               long long QE, const float dF[DIM][DIM],
                                               float fac0, float dP[DIM][DIM]) {
    float C[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) C[k] = load_c(cs + k * QE + qe);
#pragma unroll
    for (int a = 0; a < D2; ++a) {
      float s = C[plane(a, 0)] * dF[0][0];
#pragma unroll
      for (int k = 1; k < D2; ++k) s += C[plane(a, k)] * dF[k / DIM][k % DIM];
      dP[a / DIM][a % DIM] = fac0 * s;
    }
  }
};

// all D2 x D2 planes of dP/dF, C[a D2 + b] = dP_a / dF_b with a = DIM c + d
// indexing P and b = DIM g + f indexing F (ops/sweeps.py
// full_tangent_planes): 81 planes in 3D, 16 in 2D.  The material supplies
// column b at a point, `mat.column(pt, qe, QE, b, col)`: finite.cuh's
// J2Simo and J2Log one forward-mode pass seeded with e_b; the J2 family's
// Cauchy materials their closed-form tangent on e_b (j2.cuh
// CauchyStorage::column); the hyperelastic ones their closed-form C_ab.
template <int DIM>
struct FullStorage {
  static constexpr int D2 = DIM * DIM;
  static constexpr int kPlanes = D2 * D2;
  template <class Mat, typename CT>
  __device__ __forceinline__ static void store(CT* __restrict__ cout, long long qe,
                                               long long QE, const Mat& mat,
                                               const typename Mat::Point& pt) {
#pragma unroll 1
    for (int b = 0; b < D2; ++b) {
      float col[D2];
      mat.column(pt, qe, QE, b, col);
#pragma unroll
      for (int a = 0; a < D2; ++a) store_c(cout + (a * D2 + b) * QE + qe, col[a]);
    }
  }
  // dP_a = fac0 sum_b C[a D2 + b] dF_b, b in order (ops/sweeps.py
  // tangent_apply_full); each row is read as it is used
  template <typename CT>
  __device__ __forceinline__ static void apply(const CT* __restrict__ cf, long long qe,
                                               long long QE, const float dF[DIM][DIM],
                                               float fac0, float dP[DIM][DIM]) {
#pragma unroll
    for (int a = 0; a < D2; ++a) {
      float s = load_c(cf + (a * D2) * QE + qe) * dF[0][0];
#pragma unroll
      for (int b = 1; b < D2; ++b) s += load_c(cf + (a * D2 + b) * QE + qe) * dF[b / DIM][b % DIM];
      dP[a / DIM][a % DIM] = fac0 * s;
    }
  }
};

}  // namespace
