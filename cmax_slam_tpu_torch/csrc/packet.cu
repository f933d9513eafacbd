// The front-end's packet objective in one launch, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by ops/cuda_packet.py.
//
// K6 packet_objective computes, for B candidate angular velocities of one
// event packet, the negative contrast of each candidate's blurred image of
// warped events and, in its "vg" form, its gradient with respect to the
// candidate. It replaces the chain the front-end otherwise runs
// (ops/warp_local.make_local_objective): warp_events, the vote (K1), the
// blur's two band matmuls, the measure's reductions and autograd's backward
// through them with K2, about 84 graph nodes per value and gradient, each
// a few microseconds of launch latency on an image of 43 200 pixels. The
// "f" form (the value alone) serves the line search's rungs.
//
// One cluster of kCluster blocks owns one candidate's image: block k of
// the cluster holds the rows [k H / kCluster, (k + 1) H / kCluster) in
// shared memory, in two buffers A and B of its rows and four halo rows on
// each side, each row with four zero columns on each side. (One block an
// image, the whole 180x240 image in one SM's shared memory, was measured
// first: its four blur passes alone took 40-50 us on one SM, at about 50
// instructions an output; PERF.md.) In order, per block:
//   1. zero both buffers; warp every event of the packet (first-order
//      rotation, canonical projection, intrinsics) with warp_events' own
//      float32 operations in its order, each rounded (no contraction into
//      FMAs), so that every floor and drop decision is the chain's (each
//      block reads every event, as K1's banded variant P does); each warp
//      lists those with taps in the block's rows (K1's drop rule) in a list
//      of its own, then votes their taps into A, a lane each, by
//      shared-memory atomics;
//   2. blur with the separable reflect-101 Gaussian as the chain's band
//      matrices give it (ops/blur._blur_matrix, the reflection folded into
//      the band, read as tables of their nine diagonals): along W, A into
//      B; then, after the cluster's barrier, the four rows above and below
//      its own read from its neighbours' B (distributed shared memory), and
//      along H, B into A;
//   3. the measure's sums over its rows (of I and of I^2, as the crop
//      objective's contrast_from_stats takes them), summed over the cluster
//      in rank order in the first block's shared memory; the first block
//      writes -contrast (variance: s2 / N - mean^2; mean square: s2 / N);
//   4. ("vg") dL/dI_blurred in A (variance -2 (I - mean) / N, mean square
//      -2 I / N), the blur's adjoint (the transposed band matrices, which
//      the reflection makes differ from the forward's at the borders):
//      along W, A into B, the halos again, along H, B into A; then, for
//      each listed event (all events again if more than the list holds),
//      the floor-parametrized vote
//      derivative (K2's) from those taps, through d(px, py)/d(omega),
//      summed over the block and then over the cluster: no global atomics.
//
// Events: bearings (N, 3), dts (N,), weights (N,) of one packet, read by
// every block. An event is dropped unless 1 <= floor(px) < W-2,
// 1 <= floor(py) < H-2 and w != 0 (K1's rule), which keeps NaN and infinite
// coordinates out of every multiply.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifdef PACKET_PROFILE
// A profile build (tools/tune_packet.py): each block of the first cluster
// stamps %globaltimer at each phase's end.
__device__ unsigned long long g_stamps[8][16];
#define STAMP(i)                                                                   \
  do {                                                                             \
    if (blockIdx.x < 8 && threadIdx.x == 0) {                                      \
      unsigned long long t_;                                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                       \
      g_stamps[blockIdx.x][i] = t_;                                                \
    }                                                                              \
  } while (0)
#else
#define STAMP(i) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks an image (the portable cluster size)
constexpr int kHalf = 4;     // the 9-tap Gaussian of sigma 1 (OpenCV's automatic size)
constexpr int kTaps = 2 * kHalf + 1;
constexpr int kUnroll = 4;   // events in flight per thread
constexpr int kSlots = 5;    // the cluster's sums: s1, s2, and the gradient's three

struct Packet {
  const float* bearings;  // (n, 3)
  const float* dts;       // (n,)
  const float* w;         // (n,)
  int64_t n;
};

struct Camera {
  float fx, fy, cx, cy;
  int H, W;
};

// One band table: row i holds B[i, i + d - kHalf] for d in [0, kTaps) (0
// outside the matrix); rows in [margin, len - margin) are the interior taps,
// which the kernel copies to shared memory at its start.
struct Band {
  const float* tab;
  int margin;
};

struct Bands {
  Band b[4];  // B_h, B_h^T, B_w, B_w^T
};
enum { kBh, kBhT, kBw, kBwT };

// A block's rows [r0, r0 + rows) of the image, in a buffer of `pitch`
// floats a row: global row r, column x at (r - r0 + kHalf) * pitch + x + kHalf.
struct Rows {
  int r0, rows, pitch;
  __device__ __forceinline__ int at(int local_row, int x) const {
    return (local_row + kHalf) * pitch + x + kHalf;
  }
};

// An event warped under omega: its pixel, and what the gradient needs.
struct Warped {
  float px, py, inv_z, xn, yn;
};

// warp_events (ops/warp_local.py) operation by operation, each rounded.
__device__ __forceinline__ Warped warp_event(const float om[3], float bx, float by, float bz,
                                             float dt, const Camera& c) {
  const float d0 = __fmul_rn(dt, om[0]), d1 = __fmul_rn(dt, om[1]), d2 = __fmul_rn(dt, om[2]);
  const float rx = __fadd_rn(bx, __fsub_rn(__fmul_rn(d1, bz), __fmul_rn(d2, by)));
  const float ry = __fadd_rn(by, __fsub_rn(__fmul_rn(d2, bx), __fmul_rn(d0, bz)));
  const float rz = __fadd_rn(bz, __fsub_rn(__fmul_rn(d0, by), __fmul_rn(d1, bx)));
  Warped e;
  e.inv_z = __frcp_rn(rz);
  e.xn = __fmul_rn(rx, e.inv_z);
  e.yn = __fmul_rn(ry, e.inv_z);
  e.px = __fadd_rn(__fmul_rn(c.fx, e.xn), c.cx);
  e.py = __fadd_rn(__fmul_rn(c.fy, e.yn), c.cy);
  return e;
}

__device__ __forceinline__ bool kept(float fx, float fy, float w, int H, int W) {
  return fx >= 1.0f && fx < (float)(W - 2) && fy >= 1.0f && fy < (float)(H - 2) && w != 0.0f;
}

// kUnroll events e0 + k * kThreads of the packet, loaded together (weight
// 0 past its end: dropped).
struct Batch {
  float bx[kUnroll], by[kUnroll], bz[kUnroll], dt[kUnroll], w[kUnroll];
};

__device__ __forceinline__ Batch load_batch(const Packet& pk, int64_t e0) {
  Batch q;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t e = e0 + (int64_t)k * kThreads;
    const bool live = e < pk.n;
    q.bx[k] = live ? __ldg(pk.bearings + 3 * e) : 0.0f;
    q.by[k] = live ? __ldg(pk.bearings + 3 * e + 1) : 0.0f;
    q.bz[k] = live ? __ldg(pk.bearings + 3 * e + 2) : 1.0f;
    q.dt[k] = live ? __ldg(pk.dts + e) : 0.0f;
    q.w[k] = live ? __ldg(pk.w + e) : 0.0f;
  }
  return q;
}

// The sums of v[0..K) over the block, in every thread (red: K x kWarps
// floats).
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    if (lane == 0) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) s += red[k * kWarps + j];
    v[k] = s;
  }
  __syncthreads();  // red is free again
}

// The sums of each block's v[0..K) over the cluster, in rank order: every
// block puts its parts in slots [slot, slot + K) of the first block's shared
// memory; after the cluster's barrier each block that `reads` (the first
// block always) has one thread add the parts and hand the totals to its
// threads through out (K floats of its own shared memory).
template <int K>
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster, float (&v)[K],
                                             float* slots, int slot, bool reads, float* red,
                                             float* out) {
  block_sums<K>(v, red);
  if (threadIdx.x == 0) {
    float* first = cluster.map_shared_rank(slots, 0);
#pragma unroll
    for (int k = 0; k < K; ++k) first[(slot + k) * kCluster + cluster.block_rank()] = v[k];
  }
  cluster.sync();
  if (!reads) return;
  if (threadIdx.x < K) {
    const float* first = cluster.map_shared_rank(slots, 0);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kCluster; ++j) s += first[(slot + threadIdx.x) * kCluster + j];
    out[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = out[k];
}

// One pass along W over the block's rows, src into dst: out[x] = sum_d
// band[x][d] * in[x + d - kHalf] (the zero columns outside the image); taps:
// the band's interior taps in shared memory.
__device__ __forceinline__ void pass_w(const float* src, float* dst, const Rows& R, int W,
                                       Band band, const float* taps) {
  float tap[kTaps];
#pragma unroll
  for (int d = 0; d < kTaps; ++d) tap[d] = taps[d];
  const int lo = band.margin, hi = W - band.margin;
  for (int r = threadIdx.x >> 5; r < R.rows; r += kWarps) {
    for (int x = threadIdx.x & 31; x < W; x += 32) {
      const float* in = src + R.at(r, x) - kHalf;
      float acc = 0.0f;
      if (x >= lo && x < hi) {
#pragma unroll
        for (int d = 0; d < kTaps; ++d) acc = fmaf(tap[d], in[d], acc);
      } else {
        const float* row = band.tab + x * kTaps;
#pragma unroll
        for (int d = 0; d < kTaps; ++d) acc = fmaf(__ldg(row + d), in[d], acc);
      }
      dst[R.at(r, x)] = acc;
    }
  }
}

// One pass along H over the block's rows, src (its rows and both halos)
// into dst: out[r] = sum_d band[r][d] * in[r + d - kHalf] (the zero rows
// outside the image); taps as pass_w's.
__device__ __forceinline__ void pass_h(const float* src, float* dst, const Rows& R, int H, int W,
                                       Band band, const float* taps) {
  for (int r = threadIdx.x >> 5; r < R.rows; r += kWarps) {
    const int g = R.r0 + r;
    const bool inner = g >= band.margin && g < H - band.margin;
    float w[kTaps];
#pragma unroll
    for (int d = 0; d < kTaps; ++d) w[d] = inner ? taps[d] : __ldg(band.tab + g * kTaps + d);
    for (int x = threadIdx.x & 31; x < W; x += 32) {
      const float* in = src + R.at(r, x) - kHalf * R.pitch;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < kTaps; ++d) acc = fmaf(w[d], in[d * R.pitch], acc);
      dst[R.at(r, x)] = acc;
    }
  }
}

// The kHalf rows above and below the block's own in buf, read from its
// neighbours' buf (none above the first block or below the last: those
// halo rows stay zero). The caller holds the cluster's barrier before.
__device__ __forceinline__ void read_halos(cg::cluster_group& cluster, float* buf, const Rows& R,
                                           int H, int W) {
  const int rank = cluster.block_rank();
  for (int i = threadIdx.x; i < 2 * kHalf * W; i += kThreads) {
    const int side = i / (kHalf * W), q = (i / W) % kHalf, x = i % W;
    const int peer = side == 0 ? rank - 1 : rank + 1;
    if (peer < 0 || peer >= kCluster) continue;
    const int g = side == 0 ? R.r0 - kHalf + q : R.r0 + R.rows + q;  // a global row
    const int pr0 = (int)((int64_t)peer * H / kCluster);
    const float* theirs = cluster.map_shared_rank(buf, peer);
    buf[R.at(g - R.r0, x)] = theirs[R.at(g - pr0, x)];
  }
  __syncthreads();
}

// The bilinear taps of a kept event at (px, py) of weight wt that fall in
// the block's rows, added to A.
__device__ __forceinline__ void vote(float* A, const Rows& R, float px, float py, float wt) {
  const float fx = floorf(px), fy = floorf(py), dx = px - fx, dy = py - fy;
  const int ly = (int)fy - R.r0;
  float* a = A + R.at(ly, (int)fx);
  if (ly >= 0) {
    atomicAdd(a, wt * (1.0f - dx) * (1.0f - dy));
    atomicAdd(a + 1, wt * dx * (1.0f - dy));
  }
  if (ly + 1 < R.rows) {
    atomicAdd(a + R.pitch, wt * (1.0f - dx) * dy);
    atomicAdd(a + R.pitch + 1, wt * dx * dy);
  }
}

// The vote's derivative (K2's, floor held) at one kept event, split by
// the tap's row: the upper taps' part where the block holds row ly, the
// lower taps' where it holds ly + 1; then through d(px, py)/d(omega):
// px = fx * rx / rz + cx, py = fy * ry / rz + cy, d(rx, ry, rz)/d(omega_k) =
// dt * ((0, -bz, by), (bz, 0, -bx), (-by, bx, 0))_k, added to g.
__device__ __forceinline__ void gather(const float* A, const Rows& R, const Camera& c,
                                       const Warped& p, int ly, float bx, float by, float bz,
                                       float dt, float wt, float (&g)[3]) {
  const float fx = floorf(p.px), fy = floorf(p.py), dx = p.px - fx, dy = p.py - fy;
  const float* G = A + R.at(ly, (int)fx);
  float dpx = 0.0f, dpy = 0.0f;
  if (ly >= 0) {
    const float t00 = G[0], t01 = G[1];
    dpx += (1.0f - dy) * (t01 - t00);
    dpy -= (1.0f - dx) * t00 + dx * t01;
  }
  if (ly + 1 < R.rows) {
    const float t10 = G[R.pitch], t11 = G[R.pitch + 1];
    dpx += dy * (t11 - t10);
    dpy += (1.0f - dx) * t10 + dx * t11;
  }
  const float a = wt * dpx * c.fx * p.inv_z, q = wt * dpy * c.fy * p.inv_z;
  g[0] += dt * (-a * p.xn * by - q * (bz + p.yn * by));
  g[1] += dt * (a * (bz + p.xn * bx) + q * p.yn * bx);
  g[2] += dt * (q * bx - a * by);
}

// K6: a cluster of kCluster blocks per candidate b. kGrad: the "vg" form
// (value and gradient), else "f" (the value). kMeasure: 0 variance, 1 mean
// square (config's VARIANCE_CONTRAST, MEAN_SQUARE_CONTRAST). ``cap``: the
// events a block can list, cap / kWarps a warp (past it the warp votes at
// once, and the gather reads every event again).
template <bool kGrad, int kMeasure>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    packet_kernel(Packet pk, const float* __restrict__ omega, Camera c, Bands bands,
                  int buf_rows, int cap, float* __restrict__ value, float* __restrict__ grad) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const int rank = cluster.block_rank(), b = blockIdx.x / kCluster, t = threadIdx.x;
  const int lane = t & 31;
  const int H = c.H, W = c.W;
  const int r0 = (int)((int64_t)rank * H / kCluster);
  const Rows R{r0, (int)((int64_t)(rank + 1) * H / kCluster) - r0, W + 2 * kHalf};
  const int cells = buf_rows * R.pitch;  // a multiple of 4 (the planner's)
  float* A = reinterpret_cast<float*>(smem4);
  float* B = A + cells;
  float* slots = B + cells;                // kSlots x kCluster: the cluster's sums (the first block's)
  float* red = slots + kSlots * kCluster;  // 3 x kWarps: the block's sums
  float* sums = red + 3 * kWarps;          // 3: the cluster's totals
  float* taps = sums + 3;                  // 4 x kTaps: each band's interior taps
  int* count = reinterpret_cast<int*>(taps + 4 * kTaps);  // kWarps: each warp's events listed
  // Each warp's list of the events it warped with taps in the block's rows
  // (by index, warped pixel and weight): per = cap / kWarps entries from
  // warp * per; past it, the warp votes them at once.
  const int per = cap / kWarps, warp = t >> 5;
  int* list_e = count + kWarps;
  float* list_x = reinterpret_cast<float*>(list_e + cap);
  float* list_y = list_x + cap;
  float* list_w = list_y + cap;
  const float om[3] = {__ldg(omega + 3 * b), __ldg(omega + 3 * b + 1), __ldg(omega + 3 * b + 2)};

  // 1. Zero; warp every event and list those with taps in the block's rows
  // (past the list's end, vote them at once); vote the listed events' taps
  // into A, a lane each.
  STAMP(0);
  for (int i = t; i < (2 * cells) >> 2; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < 4 * kTaps) {
    const Band& band = bands.b[t / kTaps];
    taps[t] = __ldg(band.tab + band.margin * kTaps + t % kTaps);
  }
  __syncthreads();
  STAMP(1);
  int listed = 0;  // the warp's, the same in each of its lanes
  for (int64_t base = 0; base < pk.n; base += (int64_t)kThreads * kUnroll) {  // block-uniform
    const Batch q = load_batch(pk, base + t);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const Warped p = warp_event(om, q.bx[k], q.by[k], q.bz[k], q.dt[k], c);
      const float fy = floorf(p.py);
      const int ly = (int)fy - R.r0;  // the upper taps' row in the block (if kept)
      const bool mine = kept(floorf(p.px), fy, q.w[k], H, W) && ly >= -1 && ly < R.rows;
      const unsigned int m = __ballot_sync(0xffffffffu, mine);  // every lane reaches it
      const int at = listed + __popc(m & ((1u << lane) - 1u));
      listed += __popc(m);
      if (mine && at < per) {
        const int i = warp * per + at;
        list_e[i] = (int)(base + t + (int64_t)k * kThreads);
        list_x[i] = p.px;
        list_y[i] = p.py;
        list_w[i] = q.w[k];
      } else if (mine) {
        vote(A, R, p.px, p.py, q.w[k]);
      }
    }
  }
  if (lane == 0) count[warp] = listed;
  for (int i = lane; i < min(listed, per); i += 32) {
    vote(A, R, list_x[warp * per + i], list_y[warp * per + i], list_w[warp * per + i]);
  }
  __syncthreads();
  STAMP(2);

  // 2. Blur: (.) @ B_w^T along W, A into B; the halos; B_h @ (.) along H, B into A.
  pass_w(A, B, R, W, bands.b[kBw], taps + kBw * kTaps);
  __syncthreads();
  STAMP(3);
  cluster.sync();  // every block's B rows written
  STAMP(4);
  read_halos(cluster, B, R, H, W);
  STAMP(5);
  pass_h(B, A, R, H, W, bands.b[kBh], taps + kBh * kTaps);
  __syncthreads();
  STAMP(6);

  // 3. The measure's sums (of I, of I^2) over the cluster, and the value.
  const float n_pix = (float)H * (float)W;
  float s[2] = {0.0f, 0.0f};
  for (int r = t >> 5; r < R.rows; r += kWarps)
    for (int x = lane; x < W; x += 32) {
      const float v = A[R.at(r, x)];
      s[0] += v;
      s[1] += v * v;
    }
  cluster_sums<2>(cluster, s, slots, 0, kGrad || rank == 0, red, sums);
  const float mean = kMeasure == 0 ? s[0] / n_pix : 0.0f;
  if (rank == 0 && t == 0) value[b] = -(s[1] / n_pix - mean * mean);
  STAMP(7);
  if (!kGrad) return;

  // 4. dL/dI_blurred in A; (.) @ B_w along W, A into B; the halos; B_h^T @
  // (.) along H, B into A; the gather of the listed events and the
  // cluster's sums.
  const float scale = -2.0f / n_pix;
  for (int r = t >> 5; r < R.rows; r += kWarps)
    for (int x = lane; x < W; x += 32) A[R.at(r, x)] = (A[R.at(r, x)] - mean) * scale;
  __syncthreads();
  STAMP(8);
  pass_w(A, B, R, W, bands.b[kBwT], taps + kBwT * kTaps);
  cluster.sync();  // every block's B rows written, and every earlier read of them done
  STAMP(9);
  read_halos(cluster, B, R, H, W);
  pass_h(B, A, R, H, W, bands.b[kBhT], taps + kBhT * kTaps);
  __syncthreads();
  STAMP(10);
  float g[3] = {0.0f, 0.0f, 0.0f};
  int overflow = 0;
  for (int k = 0; k < kWarps; ++k) overflow |= count[k] > per;
  if (!overflow) {
    for (int i = lane; i < listed; i += 32) {
      const int64_t e = list_e[warp * per + i];
      const float bx = __ldg(pk.bearings + 3 * e), by = __ldg(pk.bearings + 3 * e + 1),
                  bz = __ldg(pk.bearings + 3 * e + 2), dt = __ldg(pk.dts + e),
                  wt = __ldg(pk.w + e);
      const Warped p = warp_event(om, bx, by, bz, dt, c);
      gather(A, R, c, p, (int)floorf(p.py) - R.r0, bx, by, bz, dt, wt, g);
    }
  } else {  // more than the list holds: every event again
    for (int64_t base = 0; base < pk.n; base += (int64_t)kThreads * kUnroll) {
      const Batch q = load_batch(pk, base + t);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const Warped p = warp_event(om, q.bx[k], q.by[k], q.bz[k], q.dt[k], c);
        const float fx = floorf(p.px), fy = floorf(p.py);
        const int ly = (int)fy - R.r0;
        if (kept(fx, fy, q.w[k], H, W) && ly >= -1 && ly < R.rows) {
          gather(A, R, c, p, ly, q.bx[k], q.by[k], q.bz[k], q.dt[k], q.w[k], g);
        }
      }
    }
  }
  __syncthreads();
  STAMP(11);
  cluster_sums<3>(cluster, g, slots, 2, rank == 0, red, sums);
  if (rank == 0 && t < 3) grad[3 * b + t] = sums[t];
  STAMP(12);
}

template <bool kGrad>
cudaError_t launch(int measure, int64_t b, int buf_rows, int cap, int smem, cudaStream_t s,
                   const Packet& pk, const float* omega, const Camera& c, const Bands& bands,
                   float* value, float* grad) {
  const unsigned int blocks = (unsigned int)(b * kCluster);
  if (measure == 0) {
    packet_kernel<kGrad, 0><<<blocks, kThreads, smem, s>>>(pk, omega, c, bands, buf_rows, cap,
                                                           value, grad);
  } else if (measure == 1) {
    packet_kernel<kGrad, 1><<<blocks, kThreads, smem, s>>>(pk, omega, c, bands, buf_rows, cap,
                                                           value, grad);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lets every form of K6 take up to `bytes` of dynamic shared memory on the
// current device (needed above 48 KB, once per device).
int packet_allow_smem(int bytes) {
  const void* fns[] = {(const void*)packet_kernel<false, 0>, (const void*)packet_kernel<false, 1>,
                       (const void*)packet_kernel<true, 0>, (const void*)packet_kernel<true, 1>};
  for (const void* fn : fns) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// K6, one launch of b clusters of kCluster blocks. grad_form: 1 "vg" (value
// and gradient), 0 "f" (value; grad unused). bearings (n, 3), dts and w
// (n,) one packet; omega (b, 3); tables: B_h, B_h^T (h x 9 each), B_w, B_w^T
// (w x 9 each), one after another, with the margins of their folded rows;
// value (b,), grad (b, 3). buf_rows: a block's buffer rows (its most rows
// and both halos; buf_rows * (w + 8) a multiple of 4); cap: the events a
// block can list, a multiple of 32; smem = 4 * (2 * buf_rows * (w + 8) +
// kSlots * kCluster + 3 * kWarps + 3 + 4 * kTaps + kWarps + 4 * cap) bytes. Returns cudaGetLastError() after
// the launch.
int packet_objective(int grad_form, int measure, const float* bearings, const float* dts,
                     const float* w, int64_t n, const float* omega, int64_t b, float fx,
                     float fy, float cx, float cy, int h, int wd, const float* tables,
                     int margin_h, int margin_ht, int margin_w, int margin_wt, int buf_rows,
                     int cap, float* value, float* grad, int smem, void* stream) {
  if (b < 1 || b * kCluster >= ((int64_t)1 << 31) || n >= ((int64_t)1 << 31) || cap < 0 ||
      h < kHalf * kCluster || wd < kTaps || cap % kWarps ||
      buf_rows < (h + kCluster - 1) / kCluster + 2 * kHalf || (buf_rows * (wd + 2 * kHalf)) % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const Packet pk{bearings, dts, w, n};
  const Camera c{fx, fy, cx, cy, h, wd};
  const Bands bands{{{tables, margin_h},
                     {tables + h * kTaps, margin_ht},
                     {tables + 2 * h * kTaps, margin_w},
                     {tables + (2 * h + wd) * kTaps, margin_wt}}};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      grad_form
          ? launch<true>(measure, b, buf_rows, cap, smem, s, pk, omega, c, bands, value, grad)
          : launch<false>(measure, b, buf_rows, cap, smem, s, pk, omega, c, bands, value, grad);
  return (int)err;
}

const char* packet_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

#ifdef PACKET_PROFILE
// The first cluster's stamps of the last launch: 8 blocks x 16 (ns).
int packet_profile_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
#endif

}  // extern "C"
