// sks_native — CPU-side runtime for the sks_tpu framework.
//
// Capability parity with the reference's C++ stack: the scalar ACA/SKS
// solvers (modules/ACA_SKS.cpp), the wall-fixture reader
// (CPU_Runtime Test/utils.cpp:6-21 format: count header, then
// "x1 y1 x2 y2" per line), and the 10M-iteration hot-loop CPU benchmark
// (CPU_Runtime Test/main.cpp:61-114).  Implemented from the same independent
// derivation as sks_tpu/ops/aca.py (see that module's docstring for the
// math); templated over float/double instead of duplicated sources.
//
// Role in the framework: independent fp64 oracle for solver parity tests,
// host-side data loading, and the reference-comparable CPU latency numbers
// (BASELINE.md Table 5).

#include <algorithm>
#include <chrono>
#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>

namespace {

// ---------------------------------------------------------------------------
// ACA: H = H_A2^{-1} . H_C . H_A1, division-free up to scale.
// Derivation in sks_tpu/ops/aca.py.  src/tar: [Mx,My,Nx,Ny,Px,Py,Qx,Qy].
template <typename T>
inline void aca_core(const T* s, const T* t, T* h) {
  const T e1x = s[2] - s[0], e1y = s[3] - s[1];
  const T f1x = s[4] - s[0], f1y = s[5] - s[1];
  const T g1x = s[6] - s[0], g1y = s[7] - s[1];
  const T f1 = e1x * f1y - e1y * f1x;
  const T alpha = f1y * g1x - f1x * g1y;
  const T beta = e1x * g1y - e1y * g1x;

  const T e2x = t[2] - t[0], e2y = t[3] - t[1];
  const T f2x = t[4] - t[0], f2y = t[5] - t[1];
  const T g2x = t[6] - t[0], g2y = t[7] - t[1];
  const T f2 = e2x * f2y - e2y * f2x;
  const T gamma = f2y * g2x - f2x * g2y;
  const T delta = e2x * g2y - e2y * g2x;

  const T c = beta * (gamma * (f1 - beta) - alpha * (f2 - delta));
  const T d = alpha * (delta * (f1 - alpha) - beta * (f2 - gamma));
  const T e = alpha * beta * (f2 - gamma - delta);
  const T ce = c + e, de = d + e;

  const T t00 = e2x * ce + t[0] * c, t01 = f2x * de + t[0] * d, t02 = t[0] * e;
  const T t10 = e2y * ce + t[1] * c, t11 = f2y * de + t[1] * d, t12 = t[1] * e;

  const T a00 = f1y, a01 = -f1x, a10 = -e1y, a11 = e1x;
  const T a02 = -(a00 * s[0] + a01 * s[1]);
  const T a12 = -(a10 * s[0] + a11 * s[1]);

  h[0] = t00 * a00 + t01 * a10;
  h[1] = t00 * a01 + t01 * a11;
  h[2] = t00 * a02 + t01 * a12 + t02 * f1;
  h[3] = t10 * a00 + t11 * a10;
  h[4] = t10 * a01 + t11 * a11;
  h[5] = t10 * a02 + t11 * a12 + t12 * f1;
  h[6] = c * a00 + d * a10;
  h[7] = c * a01 + d * a11;
  h[8] = c * a02 + d * a12 + e * f1;
}

// ---------------------------------------------------------------------------
// SKS: H = H_S2^{-1} . H_K . H_S1.  Derivation in sks_tpu/ops/sks.py.
template <typename T>
inline void sks_core(const T* s, const T* t, T* h) {
  // Similarity-canonical coords of P, Q for each plane.
  const T w1x = T(0.5) * (s[2] - s[0]), w1y = T(0.5) * (s[3] - s[1]);
  const T o1x = T(0.5) * (s[2] + s[0]), o1y = T(0.5) * (s[3] + s[1]);
  const T inv1 = T(1) / (w1x * w1x + w1y * w1y);
  const T p1dx = s[4] - o1x, p1dy = s[5] - o1y;
  const T q1dx = s[6] - o1x, q1dy = s[7] - o1y;
  const T p = (w1x * p1dx + w1y * p1dy) * inv1;
  const T q = (-w1y * p1dx + w1x * p1dy) * inv1;
  const T r = (w1x * q1dx + w1y * q1dy) * inv1;
  const T ss = (-w1y * q1dx + w1x * q1dy) * inv1;

  const T w2x = T(0.5) * (t[2] - t[0]), w2y = T(0.5) * (t[3] - t[1]);
  const T o2x = T(0.5) * (t[2] + t[0]), o2y = T(0.5) * (t[3] + t[1]);
  const T inv2 = T(1) / (w2x * w2x + w2y * w2y);
  const T p2dx = t[4] - o2x, p2dy = t[5] - o2y;
  const T q2dx = t[6] - o2x, q2dy = t[7] - o2y;
  const T p2 = (w2x * p2dx + w2y * p2dy) * inv2;
  const T q2 = (-w2y * p2dx + w2x * p2dy) * inv2;
  const T r2 = (w2x * q2dx + w2y * q2dy) * inv2;
  const T s2 = (-w2y * q2dx + w2x * q2dy) * inv2;

  // 4-DOF kernel fixing (+-1, 0): symmetric 2x2 solve (ops/sks.py docstring).
  const T k1 = q / q2, k3 = p2 * k1;
  const T k2 = ss / s2, k4 = r2 * k2;
  const T g = p * ss - r * q, hh = ss - q;
  const T invdet = T(1) / (g * g - hh * hh);
  const T rhs_a = k3 * ss - k4 * q, rhs_u = k1 * ss - k2 * q;
  const T a = (g * rhs_a - hh * rhs_u) * invdet;
  const T u = (g * rhs_u - hh * rhs_a) * invdet;
  const T invq = T(1) / q;
  const T v = (k1 - a - u * p) * invq;
  const T b = (k3 - a * p - u) * invq;

  // H_L = H_S2^{-1} @ H_K.
  const T l00 = w2x * a + o2x * u, l01 = w2x * b - w2y + o2x * v,
          l02 = w2x * u + o2x * a;
  const T l10 = w2y * a + o2y * u, l11 = w2y * b + w2x + o2y * v,
          l12 = w2y * u + o2y * a;
  const T l20 = u, l21 = v, l22 = a;

  // H = H_L @ H_S1h (up to scale).
  const T t0 = -(w1x * o1x + w1y * o1y);
  const T t1 = w1y * o1x - w1x * o1y;
  const T wsq1 = w1x * w1x + w1y * w1y;

  h[0] = l00 * w1x - l01 * w1y;
  h[1] = l00 * w1y + l01 * w1x;
  h[2] = l00 * t0 + l01 * t1 + l02 * wsq1;
  h[3] = l10 * w1x - l11 * w1y;
  h[4] = l10 * w1y + l11 * w1x;
  h[5] = l10 * t0 + l11 * t1 + l12 * wsq1;
  h[6] = l20 * w1x - l21 * w1y;
  h[7] = l20 * w1y + l21 * w1x;
  h[8] = l20 * t0 + l21 * t1 + l22 * wsq1;
}

// ---------------------------------------------------------------------------
// RHO-GE: pivot-free fixed elimination.  Mirrors sks_tpu/ops/ge.py ge_core —
// Cramer solve over the first three points with a shared 3x3 determinant,
// then the fourth point's 2x2 coupling in (h7, h8).  (Independent derivation;
// the reference GE.cpp hand-unrolls a 2x4 minor / 3x8 major tableau instead.)
template <typename T>
inline void ge_core_native(const T* s, const T* t, T* h) {
  const T x0 = s[0], y0 = s[1], x1 = s[2], y1 = s[3];
  const T x2 = s[4], y2 = s[5], x3 = s[6], y3 = s[7];
  const T X0 = t[0], Y0 = t[1], X1 = t[2], Y1 = t[3];
  const T X2 = t[4], Y2 = t[5], X3 = t[6], Y3 = t[7];

  const T det = x0 * (y1 - y2) - y0 * (x1 - x2) + (x1 * y2 - x2 * y1);
  const T inv = T(1) / det;

  // solve3(r): [x y 1] u = r over points 0..2, Cramer with shared det.
  auto solve3 = [&](T r0, T r1, T r2, T* u) {
    u[0] = (r0 * (y1 - y2) - y0 * (r1 - r2) + (r1 * y2 - r2 * y1)) * inv;
    u[1] = (x0 * (r1 - r2) - r0 * (x1 - x2) + (x1 * r2 - x2 * r1)) * inv;
    u[2] = (x0 * (y1 * r2 - y2 * r1) - y0 * (x1 * r2 - x2 * r1) +
            r0 * (x1 * y2 - x2 * y1)) *
           inv;
  };

  T u0[3], ux[3], uy[3], v0[3], vx[3], vy[3];
  solve3(X0, X1, X2, u0);
  solve3(x0 * X0, x1 * X1, x2 * X2, ux);
  solve3(y0 * X0, y1 * X1, y2 * X2, uy);
  solve3(Y0, Y1, Y2, v0);
  solve3(x0 * Y0, x1 * Y1, x2 * Y2, vx);
  solve3(y0 * Y0, y1 * Y1, y2 * Y2, vy);

  auto row = [&](const T* u) { return u[0] * x3 + u[1] * y3 + u[2]; };
  const T a11 = row(ux) - x3 * X3, a12 = row(uy) - y3 * X3;
  const T b1 = X3 - row(u0);
  const T a21 = row(vx) - x3 * Y3, a22 = row(vy) - y3 * Y3;
  const T b2 = Y3 - row(v0);
  const T inv2 = T(1) / (a11 * a22 - a12 * a21);
  const T h7 = (b1 * a22 - b2 * a12) * inv2;
  const T h8 = (a11 * b2 - a21 * b1) * inv2;

  for (int c = 0; c < 3; ++c) {
    h[c] = u0[c] + h7 * ux[c] + h8 * uy[c];
    h[3 + c] = v0[c] + h7 * vx[c] + h8 * vy[c];
  }
  h[6] = h7;
  h[7] = h8;
  h[8] = T(1);
}

// ---------------------------------------------------------------------------
// GPT-LU: classic getPerspectiveTransform 8x8 system solved by partially
// pivoted Gauss-Jordan.  Mirrors sks_tpu/ops/gpt.py gpt_core /
// linalg.solve_unrolled (static elimination order, row-max pivoting).
template <typename T>
inline void gpt_core_native(const T* s, const T* t, T* h) {
  T m[8][9];
  for (int i = 0; i < 4; ++i) {
    const T x = s[2 * i], y = s[2 * i + 1];
    const T X = t[2 * i], Y = t[2 * i + 1];
    T* rx = m[i];
    rx[0] = x; rx[1] = y; rx[2] = T(1); rx[3] = T(0); rx[4] = T(0);
    rx[5] = T(0); rx[6] = -x * X; rx[7] = -y * X; rx[8] = X;
    T* ry = m[4 + i];
    ry[0] = T(0); ry[1] = T(0); ry[2] = T(0); ry[3] = x; ry[4] = y;
    ry[5] = T(1); ry[6] = -x * Y; ry[7] = -y * Y; ry[8] = Y;
  }
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    T best = std::fabs(m[k][k]);
    for (int r = k + 1; r < 8; ++r) {
      const T v = std::fabs(m[r][k]);
      if (v > best) { best = v; piv = r; }
    }
    if (piv != k)
      for (int c = k; c < 9; ++c) std::swap(m[k][c], m[piv][c]);
    const T inv = T(1) / m[k][k];
    for (int c = k + 1; c < 9; ++c) m[k][c] *= inv;
    m[k][k] = T(1);
    for (int r = 0; r < 8; ++r) {
      if (r == k) continue;
      const T f = m[r][k];
      for (int c = k + 1; c < 9; ++c) m[r][c] -= f * m[k][c];
      m[r][k] = T(0);
    }
  }
  for (int i = 0; i < 8; ++i) h[i] = m[i][8];
  h[8] = T(1);
}

// ---------------------------------------------------------------------------
// Closed-form smallest eigenvector of a symmetric 3x3 (trigonometric
// eigenvalue + largest row-cross + one Rayleigh-shifted adjugate step).
// Mirrors sks_tpu/ops/linalg.py smallest_eigvec3_core.
template <typename T>
inline void smallest_eigvec3(T a00, T a01, T a02, T a11, T a12, T a22,
                             T* v) {
  const T tiny = std::numeric_limits<T>::min();
  const T third = T(1) / T(3);
  const T q = (a00 + a11 + a22) * third;
  const T b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  T p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
          T(2) * (a01 * a01 + a02 * a02 + a12 * a12)) / T(6);
  const T p = std::sqrt(p2 > tiny ? p2 : tiny);
  const T ip = T(1) / p;
  const T detb =
      (b00 * ip) * ((b11 * ip) * (b22 * ip) - (a12 * ip) * (a12 * ip)) -
      (a01 * ip) * ((a01 * ip) * (b22 * ip) - (a12 * ip) * (a02 * ip)) +
      (a02 * ip) * ((a01 * ip) * (a12 * ip) - (b11 * ip) * (a02 * ip));
  const T lim = T(1) - T(8) * std::numeric_limits<T>::epsilon();
  T r = detb * T(0.5);
  if (r > lim) r = lim;
  if (r < -lim) r = -lim;
  const T phi = std::acos(r) * third;
  const T lam = q + T(2) * p * std::cos(phi + T(2.0943951023931953));

  const T m00 = a00 - lam, m11 = a11 - lam, m22 = a22 - lam;
  const T rows[3][3] = {{m00, a01, a02}, {a01, m11, a12}, {a02, a12, m22}};
  T best[3] = {0, 0, 0};
  T best_n = T(-1);
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (const auto& pr : pairs) {
    const T* u = rows[pr[0]];
    const T* w = rows[pr[1]];
    const T c0 = u[1] * w[2] - u[2] * w[1];
    const T c1 = u[2] * w[0] - u[0] * w[2];
    const T c2 = u[0] * w[1] - u[1] * w[0];
    const T n = c0 * c0 + c1 * c1 + c2 * c2;
    if (n > best_n) { best[0] = c0; best[1] = c1; best[2] = c2; best_n = n; }
  }
  const T inv_n = T(1) / std::sqrt(best_n > tiny ? best_n : tiny);
  T v0 = best[0] * inv_n, v1 = best[1] * inv_n, v2 = best[2] * inv_n;

  const T rho = v0 * (a00 * v0 + a01 * v1 + a02 * v2) +
                v1 * (a01 * v0 + a11 * v1 + a12 * v2) +
                v2 * (a02 * v0 + a12 * v1 + a22 * v2);
  const T c00 = a00 - rho, c11 = a11 - rho, c22 = a22 - rho;
  const T adj00 = c11 * c22 - a12 * a12;
  const T adj01 = a02 * a12 - a01 * c22;
  const T adj02 = a01 * a12 - a02 * c11;
  const T adj11 = c00 * c22 - a02 * a02;
  const T adj12 = a01 * a02 - c00 * a12;
  const T adj22 = c00 * c11 - a01 * a01;
  const T w0 = adj00 * v0 + adj01 * v1 + adj02 * v2;
  const T w1 = adj01 * v0 + adj11 * v1 + adj12 * v2;
  const T w2 = adj02 * v0 + adj12 * v1 + adj22 * v2;
  const T wn2 = w0 * w0 + w1 * w1 + w2 * w2;
  if (wn2 > tiny) {
    const T iw = T(1) / std::sqrt(wn2);
    v[0] = w0 * iw; v[1] = w1 * iw; v[2] = w2 * iw;
  } else {
    v[0] = v0; v[1] = v1; v[2] = v2;
  }
}

// ---------------------------------------------------------------------------
// HO: Harker-O'Leary minimal-set solve.  Mirrors sks_tpu/ops/ho.py ho_core —
// isotropic normalization, closed-form elimination of (h1..h6) through
// G = C^T C, residual system D g = 0, closed-form 3x3 smallest eigenvector
// (the reference uses an iterative 8x3 SVD instead).
template <typename T>
inline void ho_core_native(const T* s, const T* t, T* h) {
  const T tiny = std::numeric_limits<T>::min();
  const T quarter = T(0.25);
  const T sqrt2 = T(1.4142135623730951);

  auto iso = [&](const T* p, T* dx, T* dy, T& cx, T& cy, T& sc) {
    cx = (p[0] + p[2] + p[4] + p[6]) * quarter;
    cy = (p[1] + p[3] + p[5] + p[7]) * quarter;
    T mean = T(0);
    for (int i = 0; i < 4; ++i) {
      dx[i] = p[2 * i] - cx;
      dy[i] = p[2 * i + 1] - cy;
      mean += std::sqrt(dx[i] * dx[i] + dy[i] * dy[i]);
    }
    mean *= quarter;
    sc = sqrt2 / (mean > tiny ? mean : tiny);
    for (int i = 0; i < 4; ++i) { dx[i] *= sc; dy[i] *= sc; }
  };

  T sx[4], sy[4], tx[4], ty[4], cx1, cy1, s1, cx2, cy2, s2;
  iso(s, sx, sy, cx1, cy1, s1);
  iso(t, tx, ty, cx2, cy2, s2);

  // G = C^T C (symmetric) and its adjugate inverse.
  T g00 = 0, g01 = 0, g02 = 0, g11 = 0, g12 = 0;
  for (int i = 0; i < 4; ++i) {
    g00 += sx[i] * sx[i];
    g01 += sx[i] * sy[i];
    g02 += sx[i];
    g11 += sy[i] * sy[i];
    g12 += sy[i];
  }
  const T g22 = T(4);
  const T ca = g11 * g22 - g12 * g12;
  const T cb = g02 * g12 - g01 * g22;
  const T cc = g01 * g12 - g02 * g11;
  const T cd = g00 * g22 - g02 * g02;
  const T ce = g01 * g02 - g00 * g12;
  const T cf = g00 * g11 - g01 * g01;
  const T dinv = T(1) / (g00 * ca + g01 * cb + g02 * cc);
  const T gi[3][3] = {{ca * dinv, cb * dinv, cc * dinv},
                      {cb * dinv, cd * dinv, ce * dinv},
                      {cc * dinv, ce * dinv, cf * dinv}};

  // reduced(vals): rows R = (P - I) diag(vals) C and M = C^T diag(vals) C.
  auto reduced = [&](const T* vals, T rows[4][3], T mmat[3][3]) {
    mmat[0][0] = mmat[0][1] = mmat[0][2] = T(0);
    mmat[1][1] = mmat[1][2] = mmat[2][2] = T(0);
    for (int i = 0; i < 4; ++i) {
      mmat[0][0] += vals[i] * sx[i] * sx[i];
      mmat[0][1] += vals[i] * sx[i] * sy[i];
      mmat[0][2] += vals[i] * sx[i];
      mmat[1][1] += vals[i] * sy[i] * sy[i];
      mmat[1][2] += vals[i] * sy[i];
      mmat[2][2] += vals[i];
    }
    mmat[1][0] = mmat[0][1]; mmat[2][0] = mmat[0][2]; mmat[2][1] = mmat[1][2];
    T k[3][3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        k[r][c] = gi[r][0] * mmat[0][c] + gi[r][1] * mmat[1][c] +
                  gi[r][2] * mmat[2][c];
    for (int i = 0; i < 4; ++i)
      for (int c = 0; c < 3; ++c) {
        const T proj = sx[i] * k[0][c] + sy[i] * k[1][c] + k[2][c];
        const T ci = (c == 0) ? sx[i] : (c == 1) ? sy[i] : T(1);
        rows[i][c] = proj - vals[i] * ci;
      }
  };

  T rx[4][3], ry[4][3], mx[3][3], my[3][3];
  reduced(tx, rx, mx);
  reduced(ty, ry, my);

  T d00 = 0, d01 = 0, d02 = 0, d11 = 0, d12 = 0, d22 = 0;
  for (int i = 0; i < 4; ++i) {
    d00 += rx[i][0] * rx[i][0] + ry[i][0] * ry[i][0];
    d01 += rx[i][0] * rx[i][1] + ry[i][0] * ry[i][1];
    d02 += rx[i][0] * rx[i][2] + ry[i][0] * ry[i][2];
    d11 += rx[i][1] * rx[i][1] + ry[i][1] * ry[i][1];
    d12 += rx[i][1] * rx[i][2] + ry[i][1] * ry[i][2];
    d22 += rx[i][2] * rx[i][2] + ry[i][2] * ry[i][2];
  }
  T g[3];
  smallest_eigvec3(d00, d01, d02, d11, d12, d22, g);

  T u[3], v[3];
  for (int r = 0; r < 3; ++r) {
    T wx = mx[r][0] * g[0] + mx[r][1] * g[1] + mx[r][2] * g[2];
    T wy = my[r][0] * g[0] + my[r][1] * g[1] + my[r][2] * g[2];
    u[r] = wx;  // reuse: gi applied below
    v[r] = wy;
  }
  T uu[3], vv[3];
  for (int r = 0; r < 3; ++r) {
    uu[r] = gi[r][0] * u[0] + gi[r][1] * u[1] + gi[r][2] * u[2];
    vv[r] = gi[r][0] * v[0] + gi[r][1] * v[1] + gi[r][2] * v[2];
  }
  const T hn[9] = {uu[0], uu[1], uu[2], vv[0], vv[1], vv[2], g[0], g[1], g[2]};

  // Denormalize: H = T2^{-1} Hn T1 (isotropic T's).
  T rt1[3][3];
  for (int r = 0; r < 3; ++r) {
    const T h0 = hn[3 * r], h1 = hn[3 * r + 1], h2 = hn[3 * r + 2];
    rt1[r][0] = h0 * s1;
    rt1[r][1] = h1 * s1;
    rt1[r][2] = h2 - s1 * (h0 * cx1 + h1 * cy1);
  }
  const T is2 = T(1) / s2;
  for (int c = 0; c < 3; ++c) {
    h[c] = rt1[0][c] * is2 + cx2 * rt1[2][c];
    h[3 + c] = rt1[1][c] * is2 + cy2 * rt1[2][c];
    h[6 + c] = rt1[2][c];
  }
}

// ---------------------------------------------------------------------------
// Cyclic Jacobi eigendecomposition of a symmetric n x n (fixed sweeps), and
// the smallest-eigenvalue column — mirrors sks_tpu/ops/linalg.py jacobi_eigh
// (a deliberately different algorithm from the reference's Golub-Reinsch
// device SVD, SURVEY §7(a)).
template <typename T, int N>
inline void jacobi_smallest_col(T a[N][N], T* v_out, int sweeps) {
  T v[N][N] = {};
  for (int i = 0; i < N; ++i) v[i][i] = T(1);
  for (int s = 0; s < sweeps; ++s) {
    // Converged? (CPU-side luxury the branch-free batched XLA form forgoes:
    // data-dependent early exit once the off-diagonal mass is negligible.)
    T off = T(0), dia = T(0);
    for (int p = 0; p < N; ++p) {
      dia += a[p][p] * a[p][p];
      for (int q = p + 1; q < N; ++q) off += a[p][q] * a[p][q];
    }
    // off/dia are sums of squares; (100 eps)^2 relative off-mass gives
    // eigenvectors accurate to ~100 eps — converged for this use.
    const T eps = T(100) * std::numeric_limits<T>::epsilon();
    if (off <= eps * eps * dia) break;
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const T apq = a[p][q];
        if (std::fabs(apq) < std::numeric_limits<T>::min()) continue;
        const T theta = (a[q][q] - a[p][p]) / (T(2) * apq);
        const T tt = (theta >= 0 ? T(1) : T(-1)) /
                     (std::fabs(theta) + std::sqrt(theta * theta + T(1)));
        const T c = T(1) / std::sqrt(tt * tt + T(1));
        const T sn = tt * c;
        // Symmetric two-sided update, touching each affected entry once.
        const T app = a[p][p], aqq = a[q][q];
        a[p][p] = app - tt * apq;
        a[q][q] = aqq + tt * apq;
        a[p][q] = a[q][p] = T(0);
        for (int k = 0; k < N; ++k) {
          if (k == p || k == q) continue;
          const T akp = a[k][p], akq = a[k][q];
          a[k][p] = a[p][k] = c * akp - sn * akq;
          a[k][q] = a[q][k] = sn * akp + c * akq;
        }
        for (int k = 0; k < N; ++k) {
          const T vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - sn * vkq;
          v[k][q] = sn * vkp + c * vkq;
        }
      }
    }
  }
  int best = 0;
  for (int i = 1; i < N; ++i)
    if (a[i][i] < a[best][best]) best = i;
  for (int i = 0; i < N; ++i) v_out[i] = v[i][best];
}

// ---------------------------------------------------------------------------
// NDLT: Hartley-normalized DLT via the block-structured 9x9 normal matrix
// and fixed-sweep Jacobi.  Mirrors sks_tpu/ops/ndlt.py ndlt_core (the
// reference builds a dense 8x9 stack and calls cv::eigen / device SVD).
template <typename T>
inline void ndlt_core_native(const T* s, const T* t, T* h) {
  // Deliberately the f32 tiny for BOTH dtypes, mirroring the Python twin
  // (ops/ndlt.py ndlt_core): the Hartley scale divides by a mean |dev| that
  // is >= a pixel for any non-coincident quad; the floor only guards
  // all-equal points and must not differ across dtypes.
  const T tiny = std::numeric_limits<float>::min();
  const T quarter = T(0.25);

  auto hartley = [&](const T* p, T* nx, T* ny, T& cx, T& cy, T& sx, T& sy) {
    cx = (p[0] + p[2] + p[4] + p[6]) * quarter;
    cy = (p[1] + p[3] + p[5] + p[7]) * quarter;
    T devx = 0, devy = 0;
    for (int i = 0; i < 4; ++i) {
      nx[i] = p[2 * i] - cx;
      ny[i] = p[2 * i + 1] - cy;
      devx += std::fabs(nx[i]);
      devy += std::fabs(ny[i]);
    }
    devx *= quarter; devy *= quarter;
    sx = T(1) / (devx > tiny ? devx : tiny);
    sy = T(1) / (devy > tiny ? devy : tiny);
    for (int i = 0; i < 4; ++i) { nx[i] *= sx; ny[i] *= sy; }
  };

  T nx[4], ny[4], tx[4], ty[4];
  T cx1, cy1, sx1, sy1, cx2, cy2, sx2, sy2;
  hartley(s, nx, ny, cx1, cy1, sx1, sy1);
  hartley(t, tx, ty, cx2, cy2, sx2, sy2);

  // Weighted sums of p p^T with weights 1, -X', -Y', X'^2 + Y'^2.
  auto wsum = [&](const T* w, T* e) {
    e[0] = e[1] = e[2] = e[3] = e[4] = e[5] = T(0);
    for (int i = 0; i < 4; ++i) {
      e[0] += w[i] * nx[i] * nx[i];
      e[1] += w[i] * nx[i] * ny[i];
      e[2] += w[i] * nx[i];
      e[3] += w[i] * ny[i] * ny[i];
      e[4] += w[i] * ny[i];
      e[5] += w[i];
    }
  };
  const T ones[4] = {1, 1, 1, 1};
  T wx[4], wy[4], wd[4];
  for (int i = 0; i < 4; ++i) {
    wx[i] = -tx[i];
    wy[i] = -ty[i];
    wd[i] = tx[i] * tx[i] + ty[i] * ty[i];
  }
  T e1[6], ex[6], ey[6], ed[6];
  wsum(ones, e1);
  wsum(wx, ex);
  wsum(wy, ey);
  wsum(wd, ed);

  auto put_block = [](T a[9][9], int r0, int c0, const T* e) {
    a[r0][c0] = e[0]; a[r0][c0 + 1] = e[1]; a[r0][c0 + 2] = e[2];
    a[r0 + 1][c0] = e[1]; a[r0 + 1][c0 + 1] = e[3]; a[r0 + 1][c0 + 2] = e[4];
    a[r0 + 2][c0] = e[2]; a[r0 + 2][c0 + 1] = e[4]; a[r0 + 2][c0 + 2] = e[5];
  };
  T a[9][9] = {};
  put_block(a, 0, 0, e1);
  put_block(a, 3, 3, e1);
  put_block(a, 0, 6, ex);
  put_block(a, 6, 0, ex);
  put_block(a, 3, 6, ey);
  put_block(a, 6, 3, ey);
  put_block(a, 6, 6, ed);

  T hn[9];
  jacobi_smallest_col<T, 9>(a, hn, 8);

  // Denormalize: H = T2^{-1} Hn T1 (anisotropic Hartley T's).
  T rt1[3][3];
  for (int r = 0; r < 3; ++r) {
    const T h0 = hn[3 * r], h1 = hn[3 * r + 1], h2 = hn[3 * r + 2];
    rt1[r][0] = h0 * sx1;
    rt1[r][1] = h1 * sy1;
    rt1[r][2] = h2 - h0 * sx1 * cx1 - h1 * sy1 * cy1;
  }
  const T isx2 = T(1) / sx2, isy2 = T(1) / sy2;
  for (int c = 0; c < 3; ++c) {
    h[c] = rt1[0][c] * isx2 + cx2 * rt1[2][c];
    h[3 + c] = rt1[1][c] * isy2 + cy2 * rt1[2][c];
    h[6 + c] = rt1[2][c];
  }
}

template <typename T>
inline void normalize9(T* h) {
  const T inv = T(1) / h[8];
  for (int i = 0; i < 9; ++i) h[i] *= inv;
}

template <typename T, void (*Core)(const T*, const T*, T*)>
void batch(const T* src, const T* tar, T* out, int64_t n, int normalize) {
  for (int64_t i = 0; i < n; ++i) {
    Core(src + 8 * i, tar + 8 * i, out + 9 * i);
    if (normalize) normalize9(out + 9 * i);
  }
}

using clk = std::chrono::steady_clock;

template <typename T, void (*Core)(const T*, const T*, T*)>
double hot_loop_ns(const T* src, const T* tar, int64_t iters) {
  // The reference's CPU benchmark shape: one cache-hot 4-point set, solver in
  // a tight loop (main.cpp:61-114).  volatile sink defeats dead-code elim.
  T h[9];
  auto t0 = clk::now();
  for (int64_t i = 0; i < iters; ++i) {
    Core(src, tar, h);
    normalize9(h);
    asm volatile("" : : "r"(h[0]), "r"(h[8]) : "memory");
  }
  auto t1 = clk::now();
  return double(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
                    .count()) /
         double(iters);
}

}  // namespace

extern "C" {

// Batched solvers. src/tar: n*8 (AoS), out: n*9 row-major homographies.
void sks_aca_f32(const float* s, const float* t, float* o, int64_t n, int nrm) {
  batch<float, aca_core<float>>(s, t, o, n, nrm);
}
void sks_aca_f64(const double* s, const double* t, double* o, int64_t n,
                 int nrm) {
  batch<double, aca_core<double>>(s, t, o, n, nrm);
}
void sks_sks_f32(const float* s, const float* t, float* o, int64_t n, int nrm) {
  batch<float, sks_core<float>>(s, t, o, n, nrm);
}
void sks_sks_f64(const double* s, const double* t, double* o, int64_t n,
                 int nrm) {
  batch<double, sks_core<double>>(s, t, o, n, nrm);
}
void sks_ge_f32(const float* s, const float* t, float* o, int64_t n, int nrm) {
  batch<float, ge_core_native<float>>(s, t, o, n, nrm);
}
void sks_ge_f64(const double* s, const double* t, double* o, int64_t n,
                int nrm) {
  batch<double, ge_core_native<double>>(s, t, o, n, nrm);
}
void sks_gpt_f32(const float* s, const float* t, float* o, int64_t n, int nrm) {
  batch<float, gpt_core_native<float>>(s, t, o, n, nrm);
}
void sks_gpt_f64(const double* s, const double* t, double* o, int64_t n,
                 int nrm) {
  batch<double, gpt_core_native<double>>(s, t, o, n, nrm);
}
void sks_ho_f32(const float* s, const float* t, float* o, int64_t n, int nrm) {
  batch<float, ho_core_native<float>>(s, t, o, n, nrm);
}
void sks_ho_f64(const double* s, const double* t, double* o, int64_t n,
                int nrm) {
  batch<double, ho_core_native<double>>(s, t, o, n, nrm);
}
void sks_ndlt_f32(const float* s, const float* t, float* o, int64_t n,
                  int nrm) {
  batch<float, ndlt_core_native<float>>(s, t, o, n, nrm);
}
void sks_ndlt_f64(const double* s, const double* t, double* o, int64_t n,
                  int nrm) {
  batch<double, ndlt_core_native<double>>(s, t, o, n, nrm);
}

// Hot-loop nanoseconds per solve (reference Table 5 configuration).
double sks_bench_aca_f32(const float* s, const float* t, int64_t iters) {
  return hot_loop_ns<float, aca_core<float>>(s, t, iters);
}
double sks_bench_aca_f64(const double* s, const double* t, int64_t iters) {
  return hot_loop_ns<double, aca_core<double>>(s, t, iters);
}
double sks_bench_sks_f32(const float* s, const float* t, int64_t iters) {
  return hot_loop_ns<float, sks_core<float>>(s, t, iters);
}
double sks_bench_sks_f64(const double* s, const double* t, int64_t iters) {
  return hot_loop_ns<double, sks_core<double>>(s, t, iters);
}
double sks_bench_ge_f32(const float* s, const float* t, int64_t iters) {
  return hot_loop_ns<float, ge_core_native<float>>(s, t, iters);
}
double sks_bench_ge_f64(const double* s, const double* t, int64_t iters) {
  return hot_loop_ns<double, ge_core_native<double>>(s, t, iters);
}
double sks_bench_gpt_f32(const float* s, const float* t, int64_t iters) {
  return hot_loop_ns<float, gpt_core_native<float>>(s, t, iters);
}
double sks_bench_gpt_f64(const double* s, const double* t, int64_t iters) {
  return hot_loop_ns<double, gpt_core_native<double>>(s, t, iters);
}
double sks_bench_ho_f32(const float* s, const float* t, int64_t iters) {
  return hot_loop_ns<float, ho_core_native<float>>(s, t, iters);
}
double sks_bench_ho_f64(const double* s, const double* t, int64_t iters) {
  return hot_loop_ns<double, ho_core_native<double>>(s, t, iters);
}
double sks_bench_ndlt_f32(const float* s, const float* t, int64_t iters) {
  return hot_loop_ns<float, ndlt_core_native<float>>(s, t, iters);
}
double sks_bench_ndlt_f64(const double* s, const double* t, int64_t iters) {
  return hot_loop_ns<double, ndlt_core_native<double>>(s, t, iters);
}

// Correspondence-file reader (reference format: count, then x1 y1 x2 y2).
// Returns the number of rows read (<= cap), or -1 on error.
int64_t sks_read_points(const char* path, double* src_xy, double* tar_xy,
                        int64_t cap) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  int64_t count = 0;
  if (std::fscanf(f, "%" SCNd64, &count) != 1) {
    std::fclose(f);
    return -1;
  }
  if (count > cap) count = cap;
  int64_t i = 0;
  for (; i < count; ++i) {
    double x1, y1, x2, y2;
    if (std::fscanf(f, "%lf %lf %lf %lf", &x1, &y1, &x2, &y2) != 4) break;
    src_xy[2 * i] = x1;
    src_xy[2 * i + 1] = y1;
    tar_xy[2 * i] = x2;
    tar_xy[2 * i + 1] = y2;
  }
  std::fclose(f);
  return i;
}

}  // extern "C"
