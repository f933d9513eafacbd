// The back-end window objective's event chain, hand-written for Hopper
// (sm_90a): from the knot increments to the image of warped events (K4) and
// back (K5). Plain C interface, loaded with ctypes by
// ops/cuda_pano_vote.py. Built with -fmad=false (see "Rounding" below).
//
// What it computes, per candidate m of M and event n of batch b = n / ebs:
//   1. knots'_k = exp(delta_mk * free_k) * knots_k   (spline.apply_masked_increments)
//   2. R_mb = the cumulative SO(3) B-spline of order 2 or 4 at batch b, from
//      knots' s_b .. s_b + order - 1 blended by coeff_b   (spline.evaluate_rotmats)
//   3. (x, y, z) = R_mb . bearing_n
//   4. px = cx + fx atan2(x, z) - x0, py = cy + fy asin(clamp(y / rho, -1, 1)) - y0
//      (warp_pano.warp_to_pano, then make_crop_objective's crop origin, read
//      from a device buffer; no origin for the full panorama)
//   5. the bilinear vote with the Pallas drop rule: an event votes only if
//      1 <= floor(px) < W - 2, 1 <= floor(py) < H - 2 and w != 0.
// K4 iwe_pano_vote_fwd writes the (M, H, W) images; K5 iwe_pano_vote_bwd
// takes g = dL/dimage and writes dL/ddelta (M, K, 3).
//
// Counterparts in the JAX package: cmax_slam_tpu/ops/warp_pano.py:71
// (warp_to_pano), :193 (make_pano_objective) and :288 (make_crop_objective),
// which XLA fuses around the Pallas vote, pallas_iwe.py:276 (_fwd_impl) and
// :307 (_vjp_bwd). In the port before these kernels the same chain ran as
// about 770 small kernels per value-and-grad evaluation (the spline on
// (M, B) tensors and autograd's backward through it, the warp around K1 and
// K2): an evaluation was bound by kernel count, not by bytes.
//
// The segment index s_b (int32) and the blending coefficients coeff_b
// (float32, order of them) do not depend on delta: the caller computes them
// once per window (spline.segment_basis) and the kernels read them.
//
// K4, a block per run of whole batches (of candidate m = blockIdx.y):
// its first threads rebuild the K perturbed knots, then one thread per batch
// R_mb, into shared memory; then the block streams its events
// component-major with 16-byte loads where aligned, rotates, projects and
// votes with global float atomics into an image zeroed beforehand (a
// 384x384 crop is 576 KiB, the 512x1024 panorama 2 MiB: no image fits in
// shared memory). Weight-0 padding leaves before any arithmetic. Bound by
// the event stream and the atomics (bytes: 16 per event read, the image
// written once).
//
// K5, a block per run of whole batches again, a warp per batch:
//   1. each lane recomputes its events' coordinates (none are saved: 8 bytes
//      per event written and read again cost more than the arithmetic),
//   2. gathers g's four taps and forms K2's one-sided floor differences
//      times w (exact zeros for a dropped event),
//   3. chains them through the projection to dL/d(x, y, z), as autograd
//      differentiates warp_to_pano (clamp passes the gradient where
//      -1 <= y / rho <= 1; asin' is infinite at +-1, as autograd's),
//   4. reduces dL/dR_mb (9 floats) over the batch's events by a fixed
//      butterfly of shuffles (ebs = 100 in every preset, not a multiple of
//      32: the lanes loop),
//   5. contracts it with dR_mb/ddelta along the 3 x order directions of the
//      knots the batch touches: lane d runs the same spline code as K4 on a
//      dual number seeded along direction d (forward mode), so no Jacobian
//      of the SO(3) log and exp is derived by hand, and its branches are
//      autograd's: torch.where selects value and tangent by the primal
//      predicate, clamp passes the tangent where lo <= x <= hi, the w < 0
//      sign flip carries none.
// The block sums its batches' contributions per knot in a fixed order and
// writes one (3K,) partial per block; the last block to finish (a
// threadfence and a counter the caller zeroes) sums the partials in a fixed
// order: the result is deterministic, run to run.
//
// Rounding. nvcc contracts a * b + c into one FMA by default, torch rounds
// each elementwise op on its own. These kernels are built with -fmad=false
// and evaluate the forward chain (knots', R, x/y/z, rho, atan2, asin,
// px/py) in the plain version's operation order, with the same CUDA math
// library functions torch's elementwise kernels call (sqrtf, sinf, cosf,
// atan2f, asinf) and torch's rewrites (x / c as x * (1 / c) for a scalar c,
// c / x as (1 / x) * c), so that the coordinates match the plain version's
// on the card bit for bit and with them every floor and drop decision.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreadsFwd = 256;
constexpr int kWarpsBwd = 8;
constexpr int kThreadsBwd = 32 * kWarpsBwd;
constexpr int kMaxKnots = 128;    // cuda_pano_vote.MAX_KNOTS
constexpr int kMaxBatches = 64;   // batches per block, cuda_pano_vote.MAX_BATCHES
constexpr int kMaxDirs = 12;      // 3 x order, order <= 4
constexpr float kEpsSq = 1e-12f;  // lie._EPS ** 2, as torch compares it in float32

// ---------------------------------------------------------------------------
// Scalars: float for the values, Dual (value and one tangent) for K5's
// forward mode through the same code.
// ---------------------------------------------------------------------------

struct Dual {
  float v, d;
  __device__ Dual(float v_ = 0.0f, float d_ = 0.0f) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator*(Dual a, float s) { return Dual(a.v * s, a.d * s); }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual vsqrt(Dual x) {
  const float r = sqrtf(x.v);
  return Dual(r, x.d / (2.0f * r));
}
__device__ __forceinline__ float vsin(float x) { return sinf(x); }
__device__ __forceinline__ Dual vsin(Dual x) { return Dual(sinf(x.v), cosf(x.v) * x.d); }
__device__ __forceinline__ float vcos(float x) { return cosf(x); }
__device__ __forceinline__ Dual vcos(Dual x) { return Dual(cosf(x.v), -sinf(x.v) * x.d); }
__device__ __forceinline__ float vatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual vatan2(Dual y, Dual x) {
  return Dual(atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v));
}
// 1 / x, as torch's reciprocal.
__device__ __forceinline__ float vrcp(float x) { return 1.0f / x; }
__device__ __forceinline__ Dual vrcp(Dual x) {
  const float r = 1.0f / x.v;
  return Dual(r, -x.d * r * r);
}
// torch.clamp: NaN passes through; the gradient passes where lo <= x <= hi.
__device__ __forceinline__ float vclamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ Dual vclamp(Dual x, float lo, float hi) {
  return Dual(vclamp(x.v, lo, hi), (x.v >= lo && x.v <= hi) ? x.d : 0.0f);
}
__device__ __forceinline__ float vclamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ Dual vclamp_min(Dual x, float lo) {
  return Dual(vclamp_min(x.v, lo), x.v >= lo ? x.d : 0.0f);
}

// ---------------------------------------------------------------------------
// The spline, templated on the scalar: spline.py's _soa_mul, _soa_log,
// _soa_exp and evaluate_rotmats, op for op.
// ---------------------------------------------------------------------------

template <class T>
struct Quat {
  T w, x, y, z;
};

template <class T>
__device__ __forceinline__ Quat<T> qmul(const Quat<T>& a, const Quat<T>& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// kSumXZY: theta^2 summed as (x^2 + z^2) + y^2, the order of torch.sum over
// a last dimension of 3 on the card (lie.exp, which perturbs the knots: two
// threads share the dimension, one adding elements 0 and 2, then a shuffle
// adds the other's); else (x^2 + y^2) + z^2 (spline._soa_exp).
template <class T, bool kSumXZY = false>
__device__ __forceinline__ Quat<T> so3_exp(T x, T y, T z) {
  const T theta_sq = kSumXZY ? x * x + z * z + y * y : x * x + y * y + z * z;
  const bool small = val(theta_sq) < kEpsSq;
  const T theta = vsqrt(small ? T(1.0f) : theta_sq);
  const T half = theta * 0.5f;
  const T sinc_half = small ? T(0.5f) - theta_sq * (1.0f / 48.0f) : vsin(half) / theta;
  const T w = small ? T(1.0f) - theta_sq * 0.125f : vcos(half);
  return {w, x * sinc_half, y * sinc_half, z * sinc_half};
}

template <class T>
__device__ __forceinline__ void so3_log(const Quat<T>& q, T& ox, T& oy, T& oz) {
  const float sign = val(q.w) < 0.0f ? -1.0f : 1.0f;
  const T w = q.w * sign, x = q.x * sign, y = q.y * sign, z = q.z * sign;
  const T n_sq = x * x + y * y + z * z;
  const bool small = val(n_sq) < kEpsSq;
  const T n = vsqrt(small ? T(1.0f) : n_sq);
  const T w_c = vclamp(w, -1.0f, 1.0f);
  const T theta = vatan2(n, w_c) * 2.0f;
  const T w_safe = vclamp_min(w_c, 0.5f);
  const T scale = small ? vrcp(w_safe) * 2.0f - (n_sq * 2.0f) / (w_safe * w_safe * w_safe * 3.0f)
                        : theta / n;
  ox = x * scale;
  oy = y * scale;
  oz = z * scale;
}

template <class T>
__device__ __forceinline__ Quat<T> lift(float4 q) {
  return {T(q.x), T(q.y), T(q.z), T(q.w)};
}

// exp(increment * free) * knot (knot as (w, x, y, z) in a float4's x, y, z,
// w), as spline.apply_masked_increments: lie.mul(lie.exp(...), knot).
template <class T>
__device__ __forceinline__ Quat<T> perturb(T dx, T dy, T dz, float free, float4 knot) {
  return qmul(so3_exp<T, true>(dx * free, dy * free, dz * free), lift<T>(knot));
}

// R (row-major 3x3) of the spline at one batch from its ORDER knots kq and
// blending coefficients c.
template <class T, int ORDER>
__device__ __forceinline__ void spline_rotmat(const Quat<T> (&kq)[ORDER], const float* c,
                                              T (&R)[9]) {
  Quat<T> res = kq[0];
#pragma unroll
  for (int j = 1; j < ORDER; ++j) {
    const Quat<T> q0_inv = {kq[j - 1].w, -kq[j - 1].x, -kq[j - 1].y, -kq[j - 1].z};
    T dx, dy, dz;
    so3_log(qmul(q0_inv, kq[j]), dx, dy, dz);
    const float cj = c[j];
    res = qmul(res, so3_exp(dx * cj, dy * cj, dz * cj));
  }
  const T xx = res.x * res.x, yy = res.y * res.y, zz = res.z * res.z;
  const T wx = res.w * res.x, wy = res.w * res.y, wz = res.w * res.z;
  const T xy = res.x * res.y, xz = res.x * res.z, yz = res.y * res.z;
  R[0] = T(1.0f) - (yy + zz) * 2.0f;
  R[1] = (xy - wz) * 2.0f;
  R[2] = (xz + wy) * 2.0f;
  R[3] = (xy + wz) * 2.0f;
  R[4] = T(1.0f) - (xx + zz) * 2.0f;
  R[5] = (yz - wx) * 2.0f;
  R[6] = (xz - wy) * 2.0f;
  R[7] = (yz + wx) * 2.0f;
  R[8] = T(1.0f) - (xx + yy) * 2.0f;
}

// ---------------------------------------------------------------------------
// Operands and the per-block set-up shared by both kernels.
// ---------------------------------------------------------------------------

struct Window {
  const float* delta;    // (M, K, 3)
  const float4* knots;   // (K, 4) as (w, x, y, z)
  const float* free;     // (K,)
  const int* seg;        // (B,)
  const float* coeff;    // (B, order)
  const float* bx;       // bearings, component-major: (3, N)
  const float* by;
  const float* bz;
  const float* w;        // (N,)
  const float* origin;   // (x0, y0), or null: the full panorama
  int K, B, ebs;
  float cx, cy, fx, fy;
  int H, W;
};

// knots' of candidate m into sk[0 .. K).
__device__ __forceinline__ void perturbed_knots(const Window& win, int m, float4* sk) {
  for (int k = threadIdx.x; k < win.K; k += blockDim.x) {
    const float* d = win.delta + ((int64_t)m * win.K + k) * 3;
    const Quat<float> q = perturb<float>(d[0], d[1], d[2], win.free[k], win.knots[k]);
    sk[k] = make_float4(q.w, q.x, q.y, q.z);
  }
}

// R of candidate m at the block's batches b0 .. b0 + nb - 1 into sR.
template <int ORDER>
__device__ __forceinline__ void batch_rotmats(const Window& win, const float4* sk, int64_t b0,
                                              int nb, float (*sR)[9]) {
  const int t = threadIdx.x;
  if (t >= nb) return;
  const int64_t b = b0 + t;
  const int s = win.seg[b];
  Quat<float> kq[ORDER];
#pragma unroll
  for (int j = 0; j < ORDER; ++j) kq[j] = lift<float>(sk[s + j]);
  float R[9];
  spline_rotmat<float, ORDER>(kq, win.coeff + b * ORDER, R);
#pragma unroll
  for (int i = 0; i < 9; ++i) sR[t][i] = R[i];
}

// An event's panorama coordinates (minus the crop origin), as warp_to_pano
// and make_crop_objective compute them; also what K5's chain needs.
struct Warped {
  float x, y, z, rho, v, px, py;
};

__device__ __forceinline__ Warped project(const float* R, float bx, float by, float bz,
                                          const Window& win) {
  Warped e;
  e.x = R[0] * bx + R[1] * by + R[2] * bz;
  e.y = R[3] * bx + R[4] * by + R[5] * bz;
  e.z = R[6] * bx + R[7] * by + R[8] * bz;
  e.rho = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
  const float phi = atan2f(e.x, e.z);
  e.v = e.y / e.rho;
  const float theta = asinf(vclamp(e.v, -1.0f, 1.0f));
  e.px = phi * win.fx + win.cx;
  e.py = theta * win.fy + win.cy;
  if (win.origin) {
    e.px = e.px - win.origin[0];
    e.py = e.py - win.origin[1];
  }
  return e;
}

__device__ __forceinline__ bool kept(float fx, float fy, float w, int H, int W) {
  return fx >= 1.0f && fx < (float)(W - 2) && fy >= 1.0f && fy < (float)(H - 2) && w != 0.0f;
}

// p[0 .. cnt) into v: one 16-byte load when four are there and aligned.
__device__ __forceinline__ void load4(const float* p, int64_t cnt, float (&v)[4]) {
  if (cnt >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < cnt ? __ldg(p + k) : 0.0f;  // weight 0: skipped
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <int ORDER>
__global__ void __launch_bounds__(kThreadsFwd) pano_vote_fwd_kernel(Window win, int bpb,
                                                                   float* __restrict__ out) {
  __shared__ float4 sk[kMaxKnots];
  __shared__ float sR[kMaxBatches][9];
  const int m = blockIdx.y;
  const int64_t b0 = (int64_t)blockIdx.x * bpb;
  const int nb = (int)min((int64_t)bpb, win.B - b0);
  perturbed_knots(win, m, sk);
  __syncthreads();
  batch_rotmats<ORDER>(win, sk, b0, nb, sR);
  __syncthreads();

  const int64_t e0 = b0 * win.ebs, e1 = (b0 + nb) * win.ebs;
  float* img = out + (int64_t)m * win.H * win.W;
  for (int64_t base = e0 + 4 * (int64_t)threadIdx.x; base < e1; base += 4 * kThreadsFwd) {
    float wt[4], bx[4], by[4], bz[4];
    load4(win.w + base, e1 - base, wt);
    load4(win.bx + base, e1 - base, bx);
    load4(win.by + base, e1 - base, by);
    load4(win.bz + base, e1 - base, bz);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (wt[k] == 0.0f) continue;  // padding, or past the block's events
      const int lb = (int)((base + k - e0) / win.ebs);
      const Warped e = project(sR[lb], bx[k], by[k], bz[k], win);
      const float fx = floorf(e.px), fy = floorf(e.py);
      if (!kept(fx, fy, wt[k], win.H, win.W)) continue;
      const float dx = e.px - fx, dy = e.py - fy;
      float* p = img + (int64_t)fy * win.W + (int64_t)fx;
      atomicAdd(p, wt[k] * (1.0f - dx) * (1.0f - dy));
      atomicAdd(p + 1, wt[k] * dx * (1.0f - dy));
      atomicAdd(p + win.W, wt[k] * (1.0f - dx) * dy);
      atomicAdd(p + win.W + 1, wt[k] * dx * dy);
    }
  }
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// dL/d(x, y, z) of one event from the upstream image g of its candidate.
__device__ __forceinline__ void event_grad(const Warped& e, float wt, const float* g,
                                           const Window& win, float& gx, float& gy,
                                           float& gz) {
  const float fx = floorf(e.px), fy = floorf(e.py);
  float dpx = 0.0f, dpy = 0.0f;
  if (kept(fx, fy, wt, win.H, win.W)) {
    const float dx = e.px - fx, dy = e.py - fy;
    const float* G = g + (int64_t)fy * win.W + (int64_t)fx;
    const float g00 = __ldg(G), g01 = __ldg(G + 1), g10 = __ldg(G + win.W),
                g11 = __ldg(G + win.W + 1);
    dpx = wt * ((1.0f - dy) * (g01 - g00) + dy * (g11 - g10));
    dpy = wt * ((1.0f - dx) * (g10 - g00) + dx * (g11 - g01));
  }
  // px = cx + fx atan2(x, z); py = cy + fy asin(clamp(y / rho)), rho = |(x, y, z)|.
  const float gphi = dpx * win.fx, gtheta = dpy * win.fy;
  const float vc = vclamp(e.v, -1.0f, 1.0f);
  const float gvc = gtheta * rsqrtf(1.0f - vc * vc);
  const float gv = (e.v >= -1.0f && e.v <= 1.0f) ? gvc : 0.0f;
  const float grho = -gv * e.y / (e.rho * e.rho);
  const float gs = grho / (2.0f * e.rho);  // d rho / d(rho^2)
  const float r2 = e.x * e.x + e.z * e.z;
  gx = gphi * e.z / r2 + gs * 2.0f * e.x;
  gy = gv / e.rho + gs * 2.0f * e.y;
  gz = -gphi * e.x / r2 + gs * 2.0f * e.z;
}

template <int ORDER>
__global__ void __launch_bounds__(kThreadsBwd) pano_vote_bwd_kernel(
    Window win, int bpb, const float* __restrict__ g, float* __restrict__ part,
    unsigned int* __restrict__ counter, float* __restrict__ ddelta) {
  constexpr int kDirs = 3 * ORDER;
  __shared__ float4 sk[kMaxKnots];
  __shared__ float sR[kMaxBatches][9];
  __shared__ float sT[kMaxBatches][kMaxDirs];
  __shared__ bool last;
  const int m = blockIdx.y;
  const int64_t b0 = (int64_t)blockIdx.x * bpb;
  const int nb = (int)min((int64_t)bpb, win.B - b0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  perturbed_knots(win, m, sk);
  __syncthreads();
  batch_rotmats<ORDER>(win, sk, b0, nb, sR);
  __syncthreads();

  const float* gm = g + (int64_t)m * win.H * win.W;
  for (int lb = warp; lb < nb; lb += kWarpsBwd) {
    const int64_t b = b0 + lb;
    float gR[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int64_t e = b * win.ebs + lane; e < (b + 1) * win.ebs; e += 32) {
      const float wt = __ldg(win.w + e);
      if (wt == 0.0f) continue;  // padding: its gradient is exactly zero
      const float bx = __ldg(win.bx + e), by = __ldg(win.by + e), bz = __ldg(win.bz + e);
      const Warped ev = project(sR[lb], bx, by, bz, win);
      float gx, gy, gz;
      event_grad(ev, wt, gm, win, gx, gy, gz);
      gR[0] += gx * bx, gR[1] += gx * by, gR[2] += gx * bz;
      gR[3] += gy * bx, gR[4] += gy * by, gR[5] += gy * bz;
      gR[6] += gz * bx, gR[7] += gz * by, gR[8] += gz * bz;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) gR[i] += __shfl_xor_sync(0xffffffffu, gR[i], off);
    }
    if (lane < kDirs) {  // lane d: forward mode along knot s_b + d / 3, component d % 3
      const int s = win.seg[b], jd = lane / 3, c = lane % 3;
      Quat<Dual> kq[ORDER];
#pragma unroll
      for (int j = 0; j < ORDER; ++j) {
        if (j == jd) {
          const float* d = win.delta + ((int64_t)m * win.K + s + j) * 3;
          kq[j] = perturb<Dual>(Dual(d[0], c == 0), Dual(d[1], c == 1), Dual(d[2], c == 2),
                                win.free[s + j], win.knots[s + j]);
        } else {
          kq[j] = lift<Dual>(sk[s + j]);
        }
      }
      Dual R[9];
      spline_rotmat<Dual, ORDER>(kq, win.coeff + b * ORDER, R);
      float t = 0.0f;
#pragma unroll
      for (int i = 0; i < 9; ++i) t += gR[i] * R[i].d;
      sT[lb][lane] = t;
    }
  }
  __syncthreads();

  // This block's contribution to each knot component, its batches in order.
  const int n3 = 3 * win.K;
  float* mine = part + ((int64_t)m * gridDim.x + blockIdx.x) * n3;
  for (int i = threadIdx.x; i < n3; i += kThreadsBwd) {
    const int k = i / 3, c = i % 3;
    float acc = 0.0f;
    for (int lb = 0; lb < nb; ++lb) {
      const int j = k - win.seg[b0 + lb];
      if (j >= 0 && j < ORDER) acc += sT[lb][3 * j + c];
    }
    mine[i] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int total = gridDim.x * gridDim.y;
    last = atomicAdd(counter, 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block: every output a warp, the blocks' partials in a fixed order.
  const int nblk = gridDim.x;
  for (int o = warp; o < (int)gridDim.y * n3; o += kWarpsBwd) {
    const int mm = o / n3, i = o % n3;
    const float* col = part + (int64_t)mm * nblk * n3 + i;
    float acc = 0.0f;
    for (int blk = lane; blk < nblk; blk += 32) acc += __ldcg(col + (int64_t)blk * n3);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) ddelta[o] = acc;
  }
}

}  // namespace

extern "C" {

// K4: M images (out zeroed by the caller) of the window's events warped by
// the knot increments delta (M, K, 3); `order` 2 or 4, `bpb` batches per
// block (at most kMaxBatches). Returns cudaGetLastError() after the launch.
int iwe_pano_vote_fwd(const float* delta, const float* knots, const float* free, const int* seg,
                      const float* coeff, const float* bearings, const float* w,
                      const float* origin, int64_t M, int K, int64_t B, int ebs, int order,
                      float cx, float cy, float fx, float fy, int H, int W, int bpb, float* out,
                      void* stream) {
  const int64_t n = B * ebs;
  const Window win{delta, reinterpret_cast<const float4*>(knots), free, seg, coeff, bearings,
                   bearings + n, bearings + 2 * n, w, origin, K, (int)B, ebs, cx, cy, fx, fy,
                   H, W};
  if (K > kMaxKnots || bpb < 1 || bpb > kMaxBatches || M > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((B + bpb - 1) / bpb), (unsigned int)M);
  const cudaStream_t s = (cudaStream_t)stream;
  if (M * B > 0) {
    if (order == 2) {
      pano_vote_fwd_kernel<2><<<grid, kThreadsFwd, 0, s>>>(win, bpb, out);
    } else if (order == 4) {
      pano_vote_fwd_kernel<4><<<grid, kThreadsFwd, 0, s>>>(win, bpb, out);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// K5: dL/ddelta (M, K, 3) from g = dL/dimage (M, H, W). part holds
// (M, ceil(B / bpb), 3K) floats of scratch; counter one zeroed uint32.
// Returns cudaGetLastError() after the launch.
int iwe_pano_vote_bwd(const float* delta, const float* knots, const float* free, const int* seg,
                      const float* coeff, const float* bearings, const float* w,
                      const float* origin, int64_t M, int K, int64_t B, int ebs, int order,
                      float cx, float cy, float fx, float fy, int H, int W, int bpb,
                      const float* g, float* part, unsigned int* counter, float* ddelta,
                      void* stream) {
  const int64_t n = B * ebs;
  const Window win{delta, reinterpret_cast<const float4*>(knots), free, seg, coeff, bearings,
                   bearings + n, bearings + 2 * n, w, origin, K, (int)B, ebs, cx, cy, fx, fy,
                   H, W};
  if (K > kMaxKnots || bpb < 1 || bpb > kMaxBatches || M > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((B + bpb - 1) / bpb), (unsigned int)M);
  const cudaStream_t s = (cudaStream_t)stream;
  if (M * B > 0) {
    if (order == 2) {
      pano_vote_bwd_kernel<2><<<grid, kThreadsBwd, 0, s>>>(win, bpb, g, part, counter, ddelta);
    } else if (order == 4) {
      pano_vote_bwd_kernel<4><<<grid, kThreadsBwd, 0, s>>>(win, bpb, g, part, counter, ddelta);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

const char* iwe_pano_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
