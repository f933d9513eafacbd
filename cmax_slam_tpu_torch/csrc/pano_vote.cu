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
// :307 (_vjp_bwd).
//
// The segment index s_b (int32) and the blending coefficients coeff_b
// (float32, order of them) do not depend on delta: the caller computes them
// once per window (spline.segment_basis) and the kernels read them.
//
// What bounds them on the card. At the main path's shapes (102 400 events
// of a window, 16 bytes each, and a 384x384 crop or the 512x1024 panorama)
// the bytes take under 1.2 us at 3.35 TB/s: the kernels are bound by
// latency, not bytes. Three chains set their time: the spline ahead of the
// events (a perturbed knot's exp, the factors' log and exp, each a run of
// dependent IEEE sqrt, atan2, sin, cos and division), each event's
// projection and, in K4, global float atomics, which serialize on one
// address: a window's events pile up on its landmarks' pixels (phase 4's
// crop has a pixel of ~480 votes). So both kernels take a run of
// consecutive events per block, a thread each, with the batches' spline on
// other threads or before a short event path, and K4 sums its block's votes
// per pixel in shared memory first (see each kernel). The design of the
// previous version (a block per run of whole batches, the spline on one
// thread per batch, a warp per batch in K5 and a last-block sum behind a
// completion counter) lost to this one at every shape of chip_smoke.py's
// phase 3 (PERF.md).
//
// Rounding. nvcc contracts a * b + c into one FMA by default, torch rounds
// each elementwise op on its own. These kernels are built with -fmad=false
// and evaluate the forward chain (knots', R, x/y/z, rho, atan2, asin,
// px/py) in the plain version's operation order, with the same CUDA math
// library functions torch's elementwise kernels call (sqrtf, sinf, cosf,
// atan2f, asinf) and torch's rewrites (x / c as x * (1 / c) for a scalar c,
// c / x as (1 / x) * c), so that the coordinates match the plain version's
// on the card bit for bit and with them every floor and drop decision. The
// backward's tangents and chain need the gradient's tolerance only: there
// the divisions and square roots are the fast intrinsics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxKnots = 128;    // cuda_pano_vote.MAX_KNOTS
constexpr int kMaxBatches = 16;   // batches a block touches, cuda_pano_vote.MAX_BATCHES
constexpr float kEpsSq = 1e-12f;  // lie._EPS ** 2, as torch compares it in float32

// ---------------------------------------------------------------------------
// Scalars: float for the values, Dual (value and one tangent) for K5's
// forward mode through the same code. Dual's value serves its tangent only
// (K5 takes R from the float pass): it divides and takes square roots with
// the fast intrinsics (__fdividef, rsqrtf), and keeps sinf and cosf, whose
// fast forms lose the relative accuracy of a small angle's sine.
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
  const float q = __fdividef(a.v, b.v);
  return Dual(q, __fdividef(a.d - q * b.d, b.v));
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual vsqrt(Dual x) {  // x > 0 wherever the spline takes a root
  const float r = x.v * rsqrtf(x.v);
  return Dual(r, __fdividef(x.d, 2.0f * r));
}
__device__ __forceinline__ float vsin(float x) { return sinf(x); }
__device__ __forceinline__ Dual vsin(Dual x) { return Dual(sinf(x.v), cosf(x.v) * x.d); }
__device__ __forceinline__ float vcos(float x) { return cosf(x); }
__device__ __forceinline__ Dual vcos(Dual x) { return Dual(cosf(x.v), -sinf(x.v) * x.d); }
__device__ __forceinline__ float vatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual vatan2(Dual y, Dual x) {
  return Dual(atan2f(y.v, x.v), __fdividef(x.v * y.d - y.v * x.d, x.v * x.v + y.v * y.v));
}
// 1 / x, as torch's reciprocal.
__device__ __forceinline__ float vrcp(float x) { return 1.0f / x; }
__device__ __forceinline__ Dual vrcp(Dual x) {
  const float r = __fdividef(1.0f, x.v);
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

// The spline's factor j: exp(c_j log(knot_{j-1}^-1 knot_j)).
template <class T>
__device__ __forceinline__ Quat<T> spline_factor(const Quat<T>& q0, const Quat<T>& q1, float cj) {
  const Quat<T> q0_inv = {q0.w, -q0.x, -q0.y, -q0.z};
  T dx, dy, dz;
  so3_log(qmul(q0_inv, q1), dx, dy, dz);
  return so3_exp(dx * cj, dy * cj, dz * cj);
}

// R (row-major 3x3) of the unit quaternion res.
template <class T>
__device__ __forceinline__ void quat_rotmat(const Quat<T>& res, T (&R)[9]) {
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
// Operands and what both kernels compute per block and per event.
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

// dL/d(x, y, z) of one event from the upstream image g of its candidate: K2's
// one-sided floor differences times w (exact zeros for a dropped event),
// chained through the projection as autograd differentiates warp_to_pano
// (clamp passes the gradient where -1 <= y / rho <= 1; asin' is infinite at
// +-1, as autograd's). The chain divides with __fdividef: the gradient
// needs its tolerance, not its last bit.
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
  const float grho = __fdividef(-gv * e.y, e.rho * e.rho);
  const float gs = __fdividef(grho, 2.0f * e.rho);  // d rho / d(rho^2)
  const float r2 = e.x * e.x + e.z * e.z;
  gx = __fdividef(gphi * e.z, r2) + gs * 2.0f * e.x;
  gy = __fdividef(gv, e.rho) + gs * 2.0f * e.y;
  gz = __fdividef(-gphi * e.x, r2) + gs * 2.0f * e.z;
}

// knots'_k of candidate m (spline.apply_masked_increments at one knot).
__device__ __forceinline__ Quat<float> perturbed_knot(const Window& win, int m, int k) {
  const float* d = win.delta + ((int64_t)m * win.K + k) * 3;
  return perturb<float>(d[0], d[1], d[2], win.free[k], win.knots[k]);
}

__device__ __forceinline__ float4 pack(const Quat<float>& q) {
  return make_float4(q.w, q.x, q.y, q.z);
}

// Phase times of each block for tools/tune_pano_vote.py (a build with
// -DPANO_PROFILE; none in the library): thread `who` writes %globaltimer
// into slot i < 8 and clock64 into slot 8 + i of its block's 16.
#ifdef PANO_PROFILE
constexpr int kProfSlots = 8;
__device__ unsigned long long* g_prof = nullptr;
__device__ __forceinline__ void prof(int slot, int who = 0) {
  if (threadIdx.x == who && g_prof) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    unsigned long long* row =
        g_prof + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * kProfSlots;
    row[slot] = ns;
    row[kProfSlots + slot] = (unsigned long long)clock64();
  }
}
#else
__device__ __forceinline__ void prof(int, int = 0) {}
#endif

// K4: a block per epb consecutive events (any batch boundaries), a thread
// per event, THREADS (256 or 512) threads.
//   1. Each thread issues its event's loads first; meanwhile the block
//      computes only what its batches need (block_rotations).
//   2. Each thread rotates and projects its event and adds its four votes
//      to a hash table of the block's pixels in shared memory (open
//      addressing on the pixel index; a vote that finds no slot in kProbes
//      goes to the image directly).
//   3. The block adds each pixel's sum to the image with one global atomic.
// Global float atomics on one address serialize, and a window's events pile
// up on the pixels of its landmarks: phase 4's crop image has a pixel of
// ~480 votes. Summing per block first cuts those chains by the events each
// landmark has in a block.
template <int THREADS>
struct VoteTable {
  static constexpr int kSlots = 8 * THREADS > 4096 ? 4096 : 8 * THREADS;
  static constexpr int kProbes = 16;
  int key[kSlots];
  float val[kSlots];
};

template <int THREADS>
__device__ __forceinline__ void table_add(VoteTable<THREADS>& tab, float* img, int key, float v) {
  using T = VoteTable<THREADS>;
  unsigned int slot = ((unsigned int)key * 2654435761u) & (T::kSlots - 1);
  for (int p = 0; p < T::kProbes; ++p, slot = (slot + 1) & (T::kSlots - 1)) {
    const int old = atomicCAS(&tab.key[slot], -1, key);
    if (old == -1 || old == key) {
      atomicAdd(&tab.val[slot], v);
      return;
    }
  }
  atomicAdd(img + key, v);
}

// The block's batch rotations for its nb batches from b0 (K4 and K5),
// by its threads t < n: thread (batch, j) the spline's factor j from its
// two perturbed knots (a batch's order - 1 factors on as many threads at
// once), then thread (batch) knot'_0 times the factors in order (as
// spline.evaluate_rotmats) and R into sR. sync() joins the n threads.
template <int ORDER, class Sync>
__device__ __forceinline__ void block_rotations(const Window& win, int m, int64_t b0, int nb,
                                                int t, int n, float4* sK0,
                                                float4 (*sF)[ORDER - 1], float (*sR)[9],
                                                Sync sync) {
  for (int i = t; i < nb * (ORDER - 1); i += n) {
    const int lb = i / (ORDER - 1), j = 1 + i % (ORDER - 1);
    const int64_t b = b0 + lb;
    const int s = win.seg[b];
    const Quat<float> q0 = perturbed_knot(win, m, s + j - 1), q1 = perturbed_knot(win, m, s + j);
    if (j == 1) sK0[lb] = pack(q0);
    sF[lb][j - 1] = pack(spline_factor(q0, q1, win.coeff[b * ORDER + j]));
  }
  sync();
  for (int lb = t; lb < nb; lb += n) {
    Quat<float> res = lift<float>(sK0[lb]);
#pragma unroll
    for (int j = 1; j < ORDER; ++j) res = qmul(res, lift<float>(sF[lb][j - 1]));
    float R[9];
    quat_rotmat(res, R);
#pragma unroll
    for (int i = 0; i < 9; ++i) sR[lb][i] = R[i];
  }
  sync();
}

// The block's events: epb consecutive ones from e0 (any batch boundaries).
struct EventSpan {
  int64_t e0, b0;
  int cnt, off, nb;  // events; the first's place in its batch b0; batches touched
};

__device__ __forceinline__ EventSpan event_span(const Window& win, int epb) {
  EventSpan sp;
  const int64_t n = (int64_t)win.B * win.ebs;
  sp.e0 = (int64_t)blockIdx.x * epb;
  sp.cnt = (int)min((int64_t)epb, n - sp.e0);
  sp.b0 = sp.e0 / win.ebs;
  sp.off = (int)(sp.e0 - sp.b0 * win.ebs);
  sp.nb = (sp.off + sp.cnt - 1) / win.ebs + 1;
  return sp;
}

template <int ORDER, int THREADS>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS / 2) pano_vote_fwd(
    Window win, int epb, float* __restrict__ out) {
  __shared__ float4 sK0[kMaxBatches];
  __shared__ float4 sF[kMaxBatches][ORDER - 1];
  __shared__ float sR[kMaxBatches][9];
  __shared__ VoteTable<THREADS> tab;
  prof(0);
  const int m = blockIdx.y, t = threadIdx.x;
  const EventSpan sp = event_span(win, epb);
  float wt = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
  if (t < sp.cnt) {
    wt = __ldg(win.w + sp.e0 + t);
    bx = __ldg(win.bx + sp.e0 + t);
    by = __ldg(win.by + sp.e0 + t);
    bz = __ldg(win.bz + sp.e0 + t);
  }
  for (int i = t; i < VoteTable<THREADS>::kSlots; i += THREADS) tab.key[i] = -1, tab.val[i] = 0.0f;
  block_rotations<ORDER>(win, m, sp.b0, sp.nb, t, THREADS, sK0, sF, sR, [] { __syncthreads(); });
  prof(1);
  float* img = out + (int64_t)m * win.H * win.W;
  if (wt != 0.0f) {  // else padding, or past the block's events
    const Warped e = project(sR[(sp.off + t) / win.ebs], bx, by, bz, win);
    const float fx = floorf(e.px), fy = floorf(e.py);
    prof(2);
    if (kept(fx, fy, wt, win.H, win.W)) {
      const float dx = e.px - fx, dy = e.py - fy;
      const int p = (int)fy * win.W + (int)fx;
      table_add(tab, img, p, wt * (1.0f - dx) * (1.0f - dy));
      table_add(tab, img, p + 1, wt * dx * (1.0f - dy));
      table_add(tab, img, p + win.W, wt * (1.0f - dx) * dy);
      table_add(tab, img, p + win.W + 1, wt * dx * dy);
    }
  }
  __syncthreads();
  prof(3);
  for (int i = t; i < VoteTable<THREADS>::kSlots; i += THREADS) {
    if (tab.key[i] >= 0) atomicAdd(img + tab.key[i], tab.val[i]);
  }
  prof(4);
}

// K5: a block per epb consecutive events (any batch boundaries, as K4),
// a thread per event, and 32 * dual_warps more threads for the tangents.
//   1. Each event thread issues its event's loads; the event threads
//      compute the block's batch rotations as K4 does (a barrier of their
//      own). Meanwhile the dual threads compute dR/ddelta along each batch's
//      3 x order directions (knot s_b + d / 3, component d % 3) on dual
//      numbers, off the events' path and as K4 computes R, factor by
//      factor: first thread (batch, factor j, side, component) the factor
//      with knot j - 1 + side perturbed along the component, and thread
//      (batch, component) knot'_0 so; then (their own barrier) thread
//      (batch, d) the product knot'_0 x factors in order with the tangents
//      of the knot d / 3 (knot'_0 if it is knot 0, factor d / 3 as side 1,
//      factor d / 3 + 1 as side 0) and R. The dual threads take the values
//      of knot'_0 and the factors from their own passes (Dual's values: the
//      float pass's to the tangents' tolerance).
//   2. Each event thread recomputes its event's coordinates from R, gathers
//      g's four taps and chains them to its dL/dR (9 products) into shared
//      memory; then (all threads joined) thread (batch, component, chunk)
//      sums one of kChunks runs of the batch's events in order, and thread
//      (batch, d) sums the chunks in a fixed tree and contracts the sum with
//      dR/ddelta_d. A batch split between two blocks contributes from both:
//      the contraction is linear.
//   3. The block sums its batches' contributions per knot in order into its
//      (3K,) partial. A second kernel (pano_vote_bwd_sum) sums the blocks'
//      partials in a fixed order: deterministic run to run, with no
//      completion counter to zero and no fence.
constexpr int kEventWarpsMax = 9;  // K5: at most 288 event threads
constexpr int kDualWarpsMax = 3;
constexpr int kChunks = 8;         // runs per batch in the block's sums (a tree of 8)
constexpr int kThreadsBwd = 352;   // at most, event and dual threads together: three
                                   // blocks of them fill an SM's registers at 56 a thread

template <int ORDER>
__global__ void __launch_bounds__(kThreadsBwd, 3)
    pano_vote_bwd(Window win, int epb, const float* __restrict__ g, float* __restrict__ part) {
  constexpr int kDirs = 3 * ORDER;
  __shared__ float4 sK0[kMaxBatches];
  __shared__ float4 sF[kMaxBatches][ORDER - 1];
  __shared__ float sR[kMaxBatches][9];
  __shared__ float4 sQ0v[kMaxBatches];               // knot'_0 (the dual pass's own)
  __shared__ float4 sQ0d[kMaxBatches][3];            // its tangents
  __shared__ float4 sFv[kMaxBatches][ORDER - 1];     // the factors
  __shared__ float4 sFd[kMaxBatches][ORDER - 1][6];  // their tangents, by side and component
  __shared__ float sT[kMaxBatches][kDirs][9];        // dR/ddelta_d
  __shared__ float sV[9][32 * kEventWarpsMax + 1];   // each event's dL/dR (+1: banks)
  __shared__ float sP[kMaxBatches][9][kChunks];      // each batch's, in chunks
  __shared__ float sC[kMaxBatches][kDirs];
  __shared__ int sS[kMaxBatches];
  prof(0);
  const int m = blockIdx.y, t = threadIdx.x;
  const int nev = (epb + 31) & ~31;  // event threads; the rest run the dual pass
  const int nthreads = blockDim.x;
  const EventSpan sp = event_span(win, epb);
  if (t < nev) {
    float wt = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    if (t < sp.cnt) {
      wt = __ldg(win.w + sp.e0 + t);
      bx = __ldg(win.bx + sp.e0 + t);
      by = __ldg(win.by + sp.e0 + t);
      bz = __ldg(win.bz + sp.e0 + t);
    }
    block_rotations<ORDER>(win, m, sp.b0, sp.nb, t, nev, sK0, sF, sR,
                           [nev] { asm volatile("bar.sync 1, %0;" ::"r"(nev)); });
    prof(1);
    float gR[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (wt != 0.0f) {  // else padding, or past the block's events: no gradient
      const Warped ev = project(sR[(sp.off + t) / win.ebs], bx, by, bz, win);
      float gx, gy, gz;
      event_grad(ev, wt, g + (int64_t)m * win.H * win.W, win, gx, gy, gz);
      prof(2);
      gR[0] = gx * bx, gR[1] = gx * by, gR[2] = gx * bz;
      gR[3] = gy * bx, gR[4] = gy * by, gR[5] = gy * bz;
      gR[6] = gz * bx, gR[7] = gz * by, gR[8] = gz * bz;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) sV[k][t] = gR[k];
    prof(3);
  } else {
    const int td = t - nev, nd = nthreads - nev;
    constexpr int kItems = 6 * (ORDER - 1) + 3;  // per batch: factor tangents, then knot'_0's
    for (int i = td; i < sp.nb * kItems; i += nd) {
      const int lb = i / kItems, r = i % kItems;
      const int64_t b = sp.b0 + lb;
      const int s = win.seg[b];
      if (r < 6 * (ORDER - 1)) {
        const int j = 1 + r / 6, side = (r % 6) / 3, c = r % 3, k = s + j - 1 + side;
        const float* dl = win.delta + ((int64_t)m * win.K + k) * 3;
        const Quat<Dual> kd = perturb<Dual>(Dual(dl[0], c == 0), Dual(dl[1], c == 1),
                                            Dual(dl[2], c == 2), win.free[k], win.knots[k]);
        const int ko = side ? k - 1 : k + 1;
        const float* dlo = win.delta + ((int64_t)m * win.K + ko) * 3;
        const Quat<Dual> other = perturb<Dual>(Dual(dlo[0]), Dual(dlo[1]), Dual(dlo[2]),
                                               win.free[ko], win.knots[ko]);
        const Quat<Dual> f = spline_factor(side ? other : kd, side ? kd : other,
                                           win.coeff[b * ORDER + j]);
        sFd[lb][j - 1][r % 6] = make_float4(f.w.d, f.x.d, f.y.d, f.z.d);
        if (r % 6 == 0) sFv[lb][j - 1] = make_float4(f.w.v, f.x.v, f.y.v, f.z.v);
      } else {
        const int c = r - 6 * (ORDER - 1);
        const float* dl = win.delta + ((int64_t)m * win.K + s) * 3;
        const Quat<Dual> q = perturb<Dual>(Dual(dl[0], c == 0), Dual(dl[1], c == 1),
                                           Dual(dl[2], c == 2), win.free[s], win.knots[s]);
        sQ0d[lb][c] = make_float4(q.w.d, q.x.d, q.y.d, q.z.d);
        if (c == 0) {
          sQ0v[lb] = make_float4(q.w.v, q.x.v, q.y.v, q.z.v);
          sS[lb] = s;
        }
      }
    }
    prof(4, nev);
    asm volatile("bar.sync 2, %0;" ::"r"(nd));
    for (int i = td; i < sp.nb * kDirs; i += nd) {
      const int lb = i / kDirs, d = i % kDirs, jd = d / 3, c = d % 3;
      const float4 q0 = sQ0v[lb], q0d = sQ0d[lb][c];
      Quat<Dual> res = {Dual(q0.x, jd == 0 ? q0d.x : 0.0f), Dual(q0.y, jd == 0 ? q0d.y : 0.0f),
                        Dual(q0.z, jd == 0 ? q0d.z : 0.0f), Dual(q0.w, jd == 0 ? q0d.w : 0.0f)};
#pragma unroll
      for (int j = 1; j < ORDER; ++j) {
        const float4 f = sFv[lb][j - 1];
        const bool on = j == jd || j == jd + 1;
        const float4 fd = sFd[lb][j - 1][(j == jd ? 3 : 0) + c];
        const Quat<Dual> fq = {Dual(f.x, on ? fd.x : 0.0f), Dual(f.y, on ? fd.y : 0.0f),
                               Dual(f.z, on ? fd.z : 0.0f), Dual(f.w, on ? fd.w : 0.0f)};
        res = qmul(res, fq);
      }
      Dual R[9];
      quat_rotmat(res, R);
#pragma unroll
      for (int k = 0; k < 9; ++k) sT[lb][d][k] = R[k].d;
    }
    prof(5, nev);
  }
  __syncthreads();
  prof(6);
  // Thread (batch, component, chunk): a run of the batch's events, in order.
  for (int i = t; i < sp.nb * 9 * kChunks; i += nthreads) {
    const int lb = i / (9 * kChunks), k = (i / kChunks) % 9, c = i % kChunks;
    const int lo = max(0, lb * win.ebs - sp.off), hi = min(sp.cnt, (lb + 1) * win.ebs - sp.off);
    const int len = (hi - lo + kChunks - 1) / kChunks;
    const int e1 = min(hi, lo + (c + 1) * len);
    float sum = 0.0f;
    for (int e = lo + c * len; e < e1; ++e) sum += sV[k][e];
    sP[lb][k][c] = sum;
  }
  __syncthreads();
  // Thread (batch, d): the chunks in a fixed tree, contracted with dR/ddelta_d.
  for (int i = t; i < sp.nb * kDirs; i += nthreads) {
    const int lb = i / kDirs, d = i % kDirs;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float* p = sP[lb][k];
      acc += (((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]))) * sT[lb][d][k];
    }
    sC[lb][d] = acc;
  }
  __syncthreads();
  // This block's contribution to each knot component, its batches in order.
  const int n3 = 3 * win.K;
  float* mine = part + ((int64_t)m * gridDim.x + blockIdx.x) * n3;
  for (int i = t; i < n3; i += nthreads) {
    const int k = i / 3, c = i % 3;
    float acc = 0.0f;
    for (int lb = 0; lb < sp.nb; ++lb) {
      const int j = k - sS[lb];
      if (j >= 0 && j < ORDER) acc += sC[lb][3 * j + c];
    }
    mine[i] = acc;
  }
  prof(7);
}

// dL/ddelta (M, 3K) from K5's partials (M, nblk, 3K): block (column group,
// m) of 32 columns x kSumSlices slices, thread (slice, column) summing the
// partials of blocks slice, slice + kSumSlices, ... in order (four loads in
// flight), then thread (0, column) the slices in order. (A tree over the
// slices, with a barrier per level, measured slower.) Deterministic.
constexpr int kSumSlices = 32;

__global__ void __launch_bounds__(32 * kSumSlices) pano_vote_bwd_sum(
    const float* __restrict__ part, int nblk, int n3, float* __restrict__ ddelta) {
  __shared__ float sAcc[kSumSlices][32];
  const int m = blockIdx.y, col = blockIdx.x * 32 + (threadIdx.x & 31), sl = threadIdx.x >> 5;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (col < n3) {
    const float* p = part + (int64_t)m * nblk * n3 + col;
    int blk = sl;
    for (; blk + 3 * kSumSlices < nblk; blk += 4 * kSumSlices) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += __ldg(p + (int64_t)(blk + u * kSumSlices) * n3);
    }
    for (; blk < nblk; blk += kSumSlices) a[0] += __ldg(p + (int64_t)blk * n3);
  }
  sAcc[sl][threadIdx.x & 31] = (a[0] + a[1]) + (a[2] + a[3]);
  __syncthreads();
  if (sl == 0 && col < n3) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kSumSlices; ++k) sum += sAcc[k][threadIdx.x];
    ddelta[(int64_t)m * n3 + col] = sum;
  }
}

}  // namespace

extern "C" {

// A block takes per_block consecutive events, a thread each, and touches at
// most kMaxBatches batches: K4 at most 512 events (blocks of 256 or 512
// threads), K5 at most 32 x kEventWarpsMax.
static bool fits(int per_block, int ebs) { return (per_block + ebs - 2) / ebs + 1 <= kMaxBatches; }

// K4: M images (out zeroed by the caller) of the window's events warped by
// the knot increments delta (M, K, 3); `order` 2 or 4. Returns
// cudaGetLastError() after the launch.
int iwe_pano_vote_fwd(const float* delta, const float* knots, const float* free, const int* seg,
                      const float* coeff, const float* bearings, const float* w,
                      const float* origin, int64_t M, int K, int64_t B, int ebs, int order,
                      float cx, float cy, float fx, float fy, int H, int W, int per_block,
                      float* out, void* stream) {
  const int64_t n = B * ebs;
  const Window win{delta, reinterpret_cast<const float4*>(knots), free, seg, coeff, bearings,
                   bearings + n, bearings + 2 * n, w, origin, K, (int)B, ebs, cx, cy, fx, fy,
                   H, W};
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (K > kMaxKnots || M > 65535 || per_block < 1 || per_block > 512 || !fits(per_block, ebs) ||
      blocks >= (1ll << 31) || (order != 2 && order != 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)blocks, (unsigned int)M);
  const cudaStream_t s = (cudaStream_t)stream;
  if (M * n > 0) {
    if (per_block <= 256) {
      if (order == 2) pano_vote_fwd<2, 256><<<grid, 256, 0, s>>>(win, per_block, out);
      else pano_vote_fwd<4, 256><<<grid, 256, 0, s>>>(win, per_block, out);
    } else {
      if (order == 2) pano_vote_fwd<2, 512><<<grid, 512, 0, s>>>(win, per_block, out);
      else pano_vote_fwd<4, 512><<<grid, 512, 0, s>>>(win, per_block, out);
    }
  }
  return (int)cudaGetLastError();
}

// K5: dL/ddelta (M, K, 3) from g = dL/dimage (M, H, W), in two launches:
// the blocks' partials into part ((M, ceil(B ebs / per_block), 3K) floats of
// scratch), then their sum. Returns cudaGetLastError() after the launches.
int iwe_pano_vote_bwd(const float* delta, const float* knots, const float* free, const int* seg,
                      const float* coeff, const float* bearings, const float* w,
                      const float* origin, int64_t M, int K, int64_t B, int ebs, int order,
                      float cx, float cy, float fx, float fy, int H, int W, int per_block,
                      const float* g, float* part, float* ddelta, void* stream) {
  const int64_t n = B * ebs;
  const Window win{delta, reinterpret_cast<const float4*>(knots), free, seg, coeff, bearings,
                   bearings + n, bearings + 2 * n, w, origin, K, (int)B, ebs, cx, cy, fx, fy,
                   H, W};
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (K > kMaxKnots || M > 65535 || per_block < 1 || per_block > 32 * kEventWarpsMax ||
      !fits(per_block, ebs) || blocks >= (1ll << 31) || (order != 2 && order != 4))
    return (int)cudaErrorInvalidValue;
  // dual warps: one item per batch, factor, side and component, or batch
  // and component of knot'_0; at most kDualWarpsMax, within kThreadsBwd
  const int items = ((per_block + ebs - 2) / ebs + 1) * (6 * (order - 1) + 3);
  const int ev = (per_block + 31) & ~31, room = (kThreadsBwd - ev) / 32;
  int dual = (items + 31) / 32;
  dual = dual < kDualWarpsMax ? dual : kDualWarpsMax;
  dual = dual < room ? dual : room;
  if (dual < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (M * n > 0) {
    const dim3 grid((unsigned int)blocks, (unsigned int)M);
    if (order == 2) pano_vote_bwd<2><<<grid, ev + 32 * dual, 0, s>>>(win, per_block, g, part);
    else pano_vote_bwd<4><<<grid, ev + 32 * dual, 0, s>>>(win, per_block, g, part);
    const dim3 sum_grid((unsigned int)((3 * K + 31) / 32), (unsigned int)M);
    pano_vote_bwd_sum<<<sum_grid, 32 * kSumSlices, 0, s>>>(part, (int)blocks, 3 * K, ddelta);
  }
  return (int)cudaGetLastError();
}

#ifdef PANO_PROFILE
// Where the kernels write their phase times (null: nowhere).
int iwe_pano_set_profile(void* buf) {
  unsigned long long* p = (unsigned long long*)buf;
  cudaMemcpyToSymbol(g_prof, &p, sizeof(p));
  return (int)cudaGetLastError();
}
#endif

const char* iwe_pano_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
