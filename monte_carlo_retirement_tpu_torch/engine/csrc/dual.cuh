// Forward-mode (JVP) scalars for the month loop of month_loop.cu.
//
// Dual<R, K> holds a primal R and K tangents. It stands in for the scalar
// type of the month step's templates (start_path, accum_month,
// retire_month, growth, the tax algebra), so jvp_kernel runs the very body
// of the forward kernels with every value carrying K directional
// derivatives, in registers.
//
// The tangent rules are those of the torch ops the plain chain
// (engine/kernel.py, ops/tax.py) runs at each line, as torch.func.jvp
// computes them, so the kernel's tangents equal the chain's under
// torch.func.jacfwd, at ties too:
//   * a + b, a - b: a' +- b';  a * b: a' b + a b';
//   * a / b: (a' - b' (a / b)) / b, torch's own form (bit-equal in float64);
//   * exp: a' exp(a); log: a' / a; log1p: a' / (a + 1); ceil: 0;
//   * abs: a' sgn(a), so 0 at a = 0;
//   * comparisons act on the primal; a select (the chain's torch.where)
//     takes the chosen side's tangents.
// The tie rules of the clamps and extrema live beside their scalar helpers
// in month_loop.cu (r_clamp_min, r_clamp_max, r_maximum, r_minimum).
//
// Included by month_loop.cu after its scalar helpers, inside its anonymous
// namespace: the Dual overloads below call them on the primal.
#pragma once

template <class R, int K>
struct Dual {
  using real = R;
  static constexpr int tangents = K;
  R v;
  R t[K];

  Dual() = default;
  // A constant: every tangent 0.
  __device__ __forceinline__ Dual(R x) : v(x) {
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = R(0);
  }
};

// Keeps R out of deduction, so a scalar operand converts (int, float) to R.
template <class R>
struct Scalar {
  using type = R;
};
template <class R>
using scalar_t = typename Scalar<R>::type;

__device__ __forceinline__ float primal(float x) { return x; }
__device__ __forceinline__ double primal(double x) { return x; }
template <class R, int K>
__device__ __forceinline__ R primal(const Dual<R, K>& x) {
  return x.v;
}

template <class T>
struct Primal {
  using type = T;
};
template <class R, int K>
struct Primal<Dual<R, K>> {
  using type = R;
};

template <class R, int K>
struct Num<Dual<R, K>> {
  static constexpr R eps = Num<R>::eps;
  static constexpr R fail_rtol = Num<R>::fail_rtol;
};

// ---------------------------------------------------------------------------
// Arithmetic
// ---------------------------------------------------------------------------
#define MCRT_DUAL_LOOP(expr)                    \
  _Pragma("unroll") for (int k = 0; k < K; ++k) { expr; }

template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator-(const Dual<R, K>& a) {
  Dual<R, K> r;
  r.v = -a.v;
  MCRT_DUAL_LOOP(r.t[k] = -a.t[k])
  return r;
}

template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator+(const Dual<R, K>& a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = a.v + b.v;
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] + b.t[k])
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator+(const Dual<R, K>& a,
                                                scalar_t<R> b) {
  Dual<R, K> r = a;
  r.v = a.v + b;
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator+(scalar_t<R> a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r = b;
  r.v = a + b.v;
  return r;
}

template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator-(const Dual<R, K>& a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = a.v - b.v;
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] - b.t[k])
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator-(const Dual<R, K>& a,
                                                scalar_t<R> b) {
  Dual<R, K> r = a;
  r.v = a.v - b;
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator-(scalar_t<R> a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = a - b.v;
  MCRT_DUAL_LOOP(r.t[k] = -b.t[k])
  return r;
}

template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator*(const Dual<R, K>& a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = a.v * b.v;
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] * b.v + a.v * b.t[k])
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator*(const Dual<R, K>& a,
                                                scalar_t<R> b) {
  Dual<R, K> r;
  r.v = a.v * b;
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] * b)
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator*(scalar_t<R> a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = a * b.v;
  MCRT_DUAL_LOOP(r.t[k] = a * b.t[k])
  return r;
}

template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator/(const Dual<R, K>& a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = a.v / b.v;
  MCRT_DUAL_LOOP(r.t[k] = (a.t[k] - b.t[k] * r.v) / b.v)
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator/(const Dual<R, K>& a,
                                                scalar_t<R> b) {
  Dual<R, K> r;
  r.v = a.v / b;
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] / b)
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> operator/(scalar_t<R> a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = a / b.v;
  MCRT_DUAL_LOOP(r.t[k] = -(b.t[k] * r.v) / b.v)
  return r;
}

#define MCRT_DUAL_ASSIGN(op)                                             \
  template <class R, int K, class B>                                     \
  __device__ __forceinline__ Dual<R, K>& operator op##=(Dual<R, K>& a,   \
                                                        const B& b) {    \
    a = a op b;                                                          \
    return a;                                                            \
  }
MCRT_DUAL_ASSIGN(+)
MCRT_DUAL_ASSIGN(-)
MCRT_DUAL_ASSIGN(*)
MCRT_DUAL_ASSIGN(/)
#undef MCRT_DUAL_ASSIGN

// Comparisons act on the primal.
#define MCRT_DUAL_COMPARE(op)                                                \
  template <class R, int K>                                                  \
  __device__ __forceinline__ bool operator op(const Dual<R, K>& a,           \
                                              const Dual<R, K>& b) {         \
    return a.v op b.v;                                                       \
  }                                                                          \
  template <class R, int K>                                                  \
  __device__ __forceinline__ bool operator op(const Dual<R, K>& a,           \
                                              scalar_t<R> b) {               \
    return a.v op b;                                                         \
  }                                                                          \
  template <class R, int K>                                                  \
  __device__ __forceinline__ bool operator op(scalar_t<R> a,                 \
                                              const Dual<R, K>& b) {         \
    return a op b.v;                                                         \
  }
MCRT_DUAL_COMPARE(<)
MCRT_DUAL_COMPARE(<=)
MCRT_DUAL_COMPARE(>)
MCRT_DUAL_COMPARE(>=)
MCRT_DUAL_COMPARE(==)
#undef MCRT_DUAL_COMPARE

// ---------------------------------------------------------------------------
// The month step's helpers
// ---------------------------------------------------------------------------
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_exp(const Dual<R, K>& a) {
  Dual<R, K> r;
  r.v = r_exp(a.v);
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] * r.v)
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_log(const Dual<R, K>& a) {
  Dual<R, K> r;
  r.v = r_log(a.v);
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] / a.v)
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_log1p(const Dual<R, K>& a) {
  Dual<R, K> r;
  r.v = r_log1p(a.v);
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] / (a.v + R(1)))
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_ceil(const Dual<R, K>& a) {
  return Dual<R, K>(r_ceil(a.v));
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_abs(const Dual<R, K>& a) {
  const R sgn = a.v > R(0) ? R(1) : a.v < R(0) ? R(-1) : R(0);
  Dual<R, K> r;
  r.v = r_abs(a.v);
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] * sgn)
  return r;
}
// torch.clamp(x, min=lo) / (x, max=hi), the bound a constant of the primal
// type (a bound that carries tangents takes r_maximum / r_minimum): x's
// tangent where x is inside the closed range, else 0.
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_clamp_min(const Dual<R, K>& x,
                                                  const scalar_t<R>& lo) {
  Dual<R, K> r;
  r.v = r_clamp_min(x.v, lo);
  const bool pass = x.v >= lo;
  MCRT_DUAL_LOOP(r.t[k] = pass ? x.t[k] : R(0))
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_clamp_max(const Dual<R, K>& x,
                                                  const scalar_t<R>& hi) {
  Dual<R, K> r;
  r.v = r_clamp_max(x.v, hi);
  const bool pass = x.v <= hi;
  MCRT_DUAL_LOOP(r.t[k] = pass ? x.t[k] : R(0))
  return r;
}
// torch.maximum / torch.minimum: the larger (smaller) side's tangent, at a
// tie half of each.
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_maximum(const Dual<R, K>& a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = r_maximum(a.v, b.v);
  const bool tie = a.v == b.v, first = a.v > b.v;
  MCRT_DUAL_LOOP(r.t[k] = tie ? (a.t[k] + b.t[k]) * R(0.5)
                              : first ? a.t[k] : b.t[k])
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_minimum(const Dual<R, K>& a,
                                                const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = r_minimum(a.v, b.v);
  const bool tie = a.v == b.v, first = a.v < b.v;
  MCRT_DUAL_LOOP(r.t[k] = tie ? (a.t[k] + b.t[k]) * R(0.5)
                              : first ? a.t[k] : b.t[k])
  return r;
}
// The primal rounded on its own, as the scalar helpers; the tangents of a
// product and a difference.
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_mul_rn(const Dual<R, K>& a,
                                               const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = r_mul_rn(a.v, b.v);
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] * b.v + a.v * b.t[k])
  return r;
}
template <class R, int K>
__device__ __forceinline__ Dual<R, K> r_sub_rn(const Dual<R, K>& a,
                                               const Dual<R, K>& b) {
  Dual<R, K> r;
  r.v = r_sub_rn(a.v, b.v);
  MCRT_DUAL_LOOP(r.t[k] = a.t[k] - b.t[k])
  return r;
}

#undef MCRT_DUAL_LOOP
