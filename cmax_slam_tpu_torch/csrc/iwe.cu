// Bilinear vote of warped events and its VJP, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by ops/cuda_iwe.py.
//
// K1 iwe_vote_fwd replaces the Pallas forward vote of
// cmax_slam_tpu/ops/pallas_iwe.py (_fwd_impl / _fwd_kernel with _sanitize),
// and on the GPU also the XLA votes the JAX package runs instead
// (ops/scatter.py: _accumulate_dense, bilinear_accumulate_two,
// bilinear_accumulate_scatter). The TPU kernel contracts per-event hat
// matrices on the matrix unit into a VMEM-resident accumulator. Here the
// accumulator lives in shared memory where the launch is wide enough, and
// K1 has two variants, chosen by shape alone (cuda_iwe.plan_vote_fwd):
//
// - P, privatized bands. One block of kThreadsP threads owns one band of an
//   image: a run of whole rows whose float32 sums fit the block's dynamic
//   shared memory. It zeroes the band, streams all N events of its image with
//   coalesced loads, tests each event's floor against the WHOLE image's
//   bounds, adds in shared memory only the taps whose row lies in its band,
//   and writes the band out with plain (16-byte where aligned) stores, zeros
//   included. No global atomics and no memset: the output needs no zeroing.
//   What bounds it is the output write (B x H x W x 4 bytes) plus the event
//   stream (re-read from L2 once per band). Taken for wide launches: from 24
//   images (the lane-batched tracker's), in bands thinned to fill one wave of
//   blocks.
// - G, global atomics. One thread per event adds its four taps straight into
//   a zeroed image with global float atomics (a native add in L2): bound by
//   atomic throughput to L2, and for narrow launches by the launch and the
//   zero fill (a second launch). For narrow launches and images whose rows
//   are too wide for a band plan worth having. A cluster-owned image in
//   distributed shared memory lost to G with its fill at every narrow shape:
//   sm_90 has no float add in shared memory, so each tap there is a
//   compare-and-swap loop (PERF.md).
//
// K2 iwe_vote_bwd replaces the Pallas VJP (_vjp_bwd: _bwd_kernel_lanes with
// _hats_T, and _bwd_kernel with _hats for the "rows"/"mixed" orientations,
// which compute the same function). Given dL/dIWE g it writes per event the
// one-sided floor derivative of the vote along x and y (dpx, dpy) and, only
// when the caller asks, the bilinear gather of g (dw): no path differentiates
// its weights, so they skip one of three (B, N) writes. The TPU kernel keeps
// the whole upstream image in VMEM and contracts hat matrices against it on
// the matrix unit; here each event needs four taps of g, two 32-byte sectors
// of scattered reads for 12 bytes of event data. K2 has two variants, chosen
// by shape alone (cuda_iwe.plan_vote_bwd):
//
// - S, staged image. One block of kThreadsS threads owns one whole image:
//   it copies it into dynamic shared memory by 1-D bulk copies (TMA,
//   cp.async.bulk completing on an mbarrier) while its threads load their
//   first events, streams the image's events with 16-byte loads and gathers
//   the taps from shared memory. What bounds it is bytes: g and the events
//   read once, the gradients written once. For wide launches of images that
//   stage whole (the lane-batched tracker's 180x240 images). Images staged
//   in bands of rows, each band re-reading all the events, lost to G at
//   every shape timed on an H100 and are not offered (PERF.md).
// - G, global gathers. One thread per event, in blocks of IWE_BWD_G_THREADS
//   (a compile-time constant, cuda_iwe.G_BWD_THREADS), so that one packet's
//   launch spreads over most SMs. Its chain is short: load, floor, an early
//   exit with zeros for a dropped event, four gathers, stores. What bounds it
//   is the SMs' throughput for scattered reads (each tap a sector of its
//   own) and, for narrow launches, the launch and that one dependent chain.
//   Several events per thread, paired 16-byte tap loads and one-wave grids
//   all lost to it on an H100 (PERF.md). For launches of fewer images (one
//   packet, one back-end crop) and images too large to stage (the
//   panoramas). Its index is 32-bit below 2^31 events and 64-bit above.
//
// K3 iwe_vote_jvp is the vote's forward-mode derivative, which the TPU
// package never wrote as a kernel: JAX's forward mode differentiates its XLA
// scatter vote (ops/scatter.py: bilinear_accumulate_scatter, reached through
// bilinear_accumulate_two inside jax.jacfwd in ops/warp_pano.py's
// derivative_images). Given coordinate tangents tpx, tpy it votes T tangent
// images: each kept event adds the floor-parametrized derivative of its four
// taps, w * (-tpx (1-dy) - tpy (1-dx)), w * (tpx (1-dy) - tpy dx),
// w * (-tpx dy + tpy (1-dx)), w * (tpx dy + tpy dx), the derivatives K2
// differentiates, into a zeroed output. What bounds it is bytes (the events,
// 2T tangent rows and T images) but what sets its time is global float
// atomics: 4T per event, and a window's events pile up on the pixels of its
// landmarks, where atomics on one address serialize. A thread takes a few
// events (not an event and a tangent), reads each and computes its floor,
// offsets and keep test once, then loops over the tangents. A block first
// looks whether any of its warps has lanes on one
// floor pixel; where so, it sorts its events by floor pixel, so that each
// warp sums runs of equal pixels (a segmented sum by shuffles) and adds each
// run once: on a window's piled events that cuts the atomics about fivefold
// (a block of 1024 events of a phase-4 window holds about 200 pixels). The
// tangent images are cut into chunks of a few, a block row each, so that
// the grid fills the card. Summing only a warp's lanes on one pixel
// (__match_any_sync, no sort), a thread per event adding each tap at once,
// and a block's sums in a shared-memory table (shared float atomics are
// compare-and-swap loops under contention on sm_90) all lost to the sort on
// a phase-4 window and were removed (PERF.md).

// The kernels take B images of H x W and each of px, py and w (K3: and the
// tangents) as a compact (B / g, N) array, flat image b reading row b / g
// (g = 1 for a full operand), so weights shared by a ladder's rungs or
// coordinates shared by the old/new split are read in place. An event is
// dropped (and gets exactly zero gradients and tangents) unless
// 1 <= floor(px) < W-2, 1 <= floor(py) < H-2 and w != 0, which is also what
// keeps NaN and infinite coordinates out of every multiply. Offsets into
// images are int64: B x H x W passes 2^31 at 2048x4096 x 256.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

#ifndef IWE_BWD_G_THREADS
#define IWE_BWD_G_THREADS 128  // cuda_iwe.G_BWD_THREADS passes it
#endif
#ifndef IWE_JVP_ITEMS
#define IWE_JVP_ITEMS 4  // cuda_iwe.JVP_ITEMS passes it
#endif
#ifndef IWE_JVP_TANGENTS
#define IWE_JVP_TANGENTS 4  // cuda_iwe.JVP_TANGENTS passes it
#endif

constexpr int kThreadsG = 256;
constexpr int kThreadsP = 1024;  // P: beat 512 at every shape timed on an H100 (PERF.md)
constexpr int kUnroll = 4;       // events in flight per thread in the band kernel
constexpr int kThreadsB = IWE_BWD_G_THREADS;
constexpr int kThreadsS = 512;
constexpr int kThreadsJ = 256;  // K3: threads per block
constexpr int kItemsJ = IWE_JVP_ITEMS;        // K3: events a thread
constexpr int kTangentsJ = IWE_JVP_TANGENTS;  // K3: tangent images per chunk
constexpr int kBarrierBytes = 16;       // S: the mbarrier ahead of the staged image
constexpr uint32_t kBulkBytes = 32768;  // S: bytes per bulk copy instruction

// Compact event operands: flat image b reads row b / g* of each.
struct Events {
  const float* px;
  const float* py;
  const float* w;
  int64_t gx, gy, gw;
  int64_t n;
};

__device__ __forceinline__ bool in_bounds(float fx, float fy, float w, int H, int W) {
  return fx >= 1.0f && fx < (float)(W - 2) && fy >= 1.0f && fy < (float)(H - 2) &&
         w != 0.0f;
}

__global__ void vote_fwd_g_kernel(Events ev, float* __restrict__ out, int64_t total, int H,
                                  int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / ev.n, e = i - b * ev.n;
  const float x = ev.px[(b / ev.gx) * ev.n + e], y = ev.py[(b / ev.gy) * ev.n + e],
              wt = ev.w[(b / ev.gw) * ev.n + e];
  const float fx = floorf(x), fy = floorf(y);
  if (!in_bounds(fx, fy, wt, H, W)) return;
  const float dx = x - fx, dy = y - fy;
  float* img = out + b * (int64_t)H * W + (int64_t)fy * W + (int64_t)fx;
  atomicAdd(img, wt * (1.0f - dx) * (1.0f - dy));
  atomicAdd(img + 1, wt * dx * (1.0f - dy));
  atomicAdd(img + W, wt * (1.0f - dx) * dy);
  atomicAdd(img + W + 1, wt * dx * dy);
}

// Adds to the band [r0, r0 + rows) held in shared memory (band-local rows)
// the taps of one event that fall in it. The in-bounds test is on the
// global floor; an event with floor(py) = r0 - 1 gives the band its lower
// taps only, one with floor(py) = r0 + rows - 1 its upper taps only.
__device__ __forceinline__ void tap_band(float* acc, float x, float y, float wt, int r0,
                                         int rows, int H, int W) {
  const float fx = floorf(x), fy = floorf(y);
  if (!in_bounds(fx, fy, wt, H, W)) return;
  const int ly = (int)fy - r0;
  if (ly < -1 || ly >= rows) return;
  const float dx = x - fx, dy = y - fy;
  const int ix = (int)fx;
  if (ly >= 0) {
    float* a = acc + ly * W + ix;
    atomicAdd(a, wt * (1.0f - dx) * (1.0f - dy));
    atomicAdd(a + 1, wt * dx * (1.0f - dy));
  }
  if (ly + 1 < rows) {
    float* a = acc + (ly + 1) * W + ix;
    atomicAdd(a, wt * (1.0f - dx) * dy);
    atomicAdd(a + 1, wt * dx * dy);
  }
}

// Variant P. Block index = image * bands + band, so the bands of one image
// run side by side and share its events in L2.
__global__ void __launch_bounds__(kThreadsP) vote_fwd_band_kernel(Events ev,
                                                                 float* __restrict__ out,
                                                                 int bands, int rows, int H,
                                                                 int W) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int band = (int)(blockIdx.x % bands);
  const int64_t b = blockIdx.x / bands;
  const int r0 = band * rows;
  const int nrows = min(rows, H - r0);
  const int count = nrows * W;

  const int n4 = count >> 2;
  for (int i = threadIdx.x; i < n4; i += kThreadsP) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = (n4 << 2) + threadIdx.x; i < count; i += kThreadsP) acc[i] = 0.0f;
  __syncthreads();

  const float* px = ev.px + (b / ev.gx) * ev.n;
  const float* py = ev.py + (b / ev.gy) * ev.n;
  const float* pw = ev.w + (b / ev.gw) * ev.n;
  constexpr int64_t step = (int64_t)kThreadsP * kUnroll;
  for (int64_t base = threadIdx.x; base < ev.n; base += step) {
    float x[kUnroll], y[kUnroll], wt[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t e = base + (int64_t)k * kThreadsP;
      const bool live = e < ev.n;
      x[k] = live ? __ldg(px + e) : 0.0f;
      y[k] = live ? __ldg(py + e) : 0.0f;
      wt[k] = live ? __ldg(pw + e) : 0.0f;  // weight 0: dropped
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) tap_band(acc, x[k], y[k], wt[k], r0, nrows, H, W);
  }
  __syncthreads();

  float* dst = out + (b * H + r0) * (int64_t)W;
  // Scalar stores up to the first 16-byte boundary, float4 stores, scalar tail.
  const int head = min(count, (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2));
  for (int i = threadIdx.x; i < head; i += kThreadsP) dst[i] = acc[i];
  const int m4 = (count - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < m4; i += kThreadsP) {
    const float* s = acc + head + 4 * i;
    d4[i] = make_float4(s[0], s[1], s[2], s[3]);
  }
  for (int i = head + 4 * m4 + threadIdx.x; i < count; i += kThreadsP) dst[i] = acc[i];
}

// K2's gradients, (B, N) each; dw null when the caller needs no weight gradient.
struct Grads {
  float* dpx;
  float* dpy;
  float* dw;
};

// p[0..cnt) into v (zeros past cnt): one 16-byte load when a group of four
// is all there and aligned, else scalar loads.
__device__ __forceinline__ void load4(const float* p, int64_t cnt, float (&v)[4]) {
  if (cnt >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < cnt ? __ldg(p + k) : 0.0f;
}

// v[0..cnt) into p: one 16-byte store when a group of four is all there and
// aligned, else scalar stores.
__device__ __forceinline__ void store4(float* p, int64_t cnt, const float (&v)[4]) {
  if (cnt >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < cnt) p[k] = v[k];
  }
}

// Events e .. e + 3 of one image, read from its rows px, py, pw of n events
// (weight 0 past the row's end: dropped).
struct Quad {
  float x[4], y[4], w[4];
};

__device__ __forceinline__ Quad load_quad(const float* px, const float* py, const float* pw,
                                          int64_t n, int64_t e) {
  Quad q;
  load4(px + e, n - e, q.x);
  load4(py + e, n - e, q.y);
  load4(pw + e, n - e, q.w);
  return q;
}

// Where event e of image b (flat index i = b * n + e) lies in an operand
// grouped by g.
template <typename I>
__device__ __forceinline__ int64_t event_at(I i, I b, I e, int64_t g, int64_t n) {
  return g == 1 ? (int64_t)i : (int64_t)(b / (I)g) * n + e;
}

// Variant G: one thread per event, thread i on event i % n of image i / n.
// I is the index type: 32-bit where b x n < 2^31 (every path's launch), so
// that the divide stays short; 64-bit beyond. kGrouped: some operand is
// grouped (g > 1). Without groups (every path's K2 launch) the events load
// from i at once, with no divide ahead of them; i / n, which only the
// gather needs, overlaps their latency.
template <typename I, bool kGrouped>
__global__ void __launch_bounds__(kThreadsB) vote_bwd_g_kernel(Events ev,
                                                               const float* __restrict__ g,
                                                               Grads out, I total, int H,
                                                               int W) {
  const I i = (I)blockIdx.x * kThreadsB + threadIdx.x;
  if (i >= total) return;
  const I n = (I)ev.n, b = i / n, e = i - b * n;
  float x, y, wt;
  if constexpr (kGrouped) {
    x = __ldg(ev.px + event_at(i, b, e, ev.gx, ev.n));
    y = __ldg(ev.py + event_at(i, b, e, ev.gy, ev.n));
    wt = __ldg(ev.w + event_at(i, b, e, ev.gw, ev.n));
  } else {
    x = __ldg(ev.px + i);
    y = __ldg(ev.py + i);
    wt = __ldg(ev.w + i);
  }
  const float fx = floorf(x), fy = floorf(y);
  if (!in_bounds(fx, fy, wt, H, W)) {
    out.dpx[i] = 0.0f;
    out.dpy[i] = 0.0f;
    if (out.dw) out.dw[i] = 0.0f;
    return;
  }
  const float dx = x - fx, dy = y - fy;
  const float* G = g + (int64_t)b * H * W + (int64_t)fy * W + (int)fx;
  const float g00 = __ldg(G), g01 = __ldg(G + 1), g10 = __ldg(G + W), g11 = __ldg(G + W + 1);
  out.dpx[i] = wt * ((1.0f - dy) * (g01 - g00) + dy * (g11 - g10));
  out.dpy[i] = wt * ((1.0f - dx) * (g10 - g00) + dx * (g11 - g01));
  if (out.dw) {
    out.dw[i] = (1.0f - dy) * ((1.0f - dx) * g00 + dx * g01) + dy * ((1.0f - dx) * g10 + dx * g11);
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// S's gradients of the four events e .. e + 3 of image b held in q, with
// the taps read from img, the whole image staged in shared memory. All 16
// tap reads are issued unconditionally (a dropped event reads img's first
// pixels and ignores them), so they are in flight together.
__device__ __forceinline__ void staged_quad(const Quad& q, const Events& ev, int64_t b,
                                            int64_t e, const float* img, int H, int W,
                                            const Grads& out) {
  float t00[4], t01[4], t10[4], t11[4], dx[4], dy[4];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float fx = floorf(q.x[k]), fy = floorf(q.y[k]);
    const bool valid = in_bounds(fx, fy, q.w[k], H, W);
    live |= (unsigned)valid << k;
    const int i = valid ? (int)fy * W + (int)fx : 0;
    const int sx = valid ? 1 : 0, sy = valid ? W : 0;
    t00[k] = img[i];
    t01[k] = img[i + sx];
    t10[k] = img[i + sy];
    t11[k] = img[i + sy + sx];
    dx[k] = q.x[k] - fx;
    dy[k] = q.y[k] - fy;
  }
  float gx[4], gy[4], gw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool l = (live >> k) & 1u;
    const float ax = dx[k], ay = dy[k];
    gw[k] = l ? (1.0f - ay) * ((1.0f - ax) * t00[k] + ax * t01[k]) +
                    ay * ((1.0f - ax) * t10[k] + ax * t11[k])
              : 0.0f;
    gx[k] = l ? q.w[k] * ((1.0f - ay) * (t01[k] - t00[k]) + ay * (t11[k] - t10[k])) : 0.0f;
    gy[k] = l ? q.w[k] * ((1.0f - ax) * (t10[k] - t00[k]) + ax * (t11[k] - t01[k])) : 0.0f;
  }
  const int64_t o = b * ev.n + e, cnt = ev.n - e;
  store4(out.dpx + o, cnt, gx);
  store4(out.dpy + o, cnt, gy);
  if (out.dw) store4(out.dw + o, cnt, gw);
}

// Variant S, one block per image. Dynamic shared memory: the mbarrier, then
// the image. W % 4 == 0 and g 16-byte aligned (the wrapper's checks) make
// every bulk copy's address and size multiples of 16.
__global__ void __launch_bounds__(kThreadsS) vote_bwd_staged_kernel(Events ev,
                                                                    const float* __restrict__ g,
                                                                    Grads out, int H, int W) {
  extern __shared__ float4 smem4[];
  const float* img = reinterpret_cast<const float*>(smem4) + kBarrierBytes / 4;
  const uint32_t bar = shared_addr(smem4);
  const int64_t b = blockIdx.x;
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)H * (uint32_t)W * 4u;
    const char* src = reinterpret_cast<const char*>(g + b * H * (int64_t)W);
    const uint32_t dst = shared_addr(img);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
    for (uint32_t off = 0; off < bytes; off += kBulkBytes) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(dst + off),
          "l"(reinterpret_cast<uint64_t>(src + off)), "r"(min(kBulkBytes, bytes - off)), "r"(bar)
          : "memory");
    }
  }
  __syncthreads();  // the barrier is initialized before any thread waits on it

  const float* px = ev.px + (b / ev.gx) * ev.n;
  const float* py = ev.py + (b / ev.gy) * ev.n;
  const float* pw = ev.w + (b / ev.gw) * ev.n;
  constexpr int64_t step = 4 * kThreadsS;
  int64_t e = 4 * (int64_t)threadIdx.x;
  Quad q = load_quad(px, py, pw, ev.n, e);  // in flight with the bulk copy
  uint32_t done = 0;
  while (!done) {  // phase 0 completes when the copies' bytes have landed
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(0u) : "memory");
  }
  for (; e < ev.n; e += step) {
    const Quad next = load_quad(px, py, pw, ev.n, e + step);
    staged_quad(q, ev, b, e, img, H, W, out);
    q = next;
  }
}

// K3's coordinate tangents, compact like the events: tangent image b reads
// row b / g* of each.
struct Tangents {
  const float* tpx;
  const float* tpy;
  int64_t gx, gy;
};

// K3's launch: tangent images [group * span + j * tpt, ...) of a chunk.
// Every image of a span of `span` images (the greatest common divisor of
// the event operands' row groups) reads one row of px, py and w; a chunk
// takes at most `tpt` (kTangentsJ) of them.
struct JvpPlan {
  int64_t b;      // tangent images
  int span, tpt;  // images sharing an event row; images per chunk
  int H, W;
};

__device__ __forceinline__ void jvp_chunk(const JvpPlan& pl, int64_t* b0, int64_t* b1) {
  const int per = (pl.span + pl.tpt - 1) / pl.tpt;  // chunks per span
  const int64_t group = blockIdx.y / per;
  const int j = blockIdx.y - (int)(group * per);
  *b0 = group * pl.span + (int64_t)j * pl.tpt;
  *b1 = min(*b0 + pl.tpt, (group + 1) * pl.span);
}

// One event of a chunk: loaded once, its floor, offsets and keep test
// computed once for all the chunk's tangent images. key is the floor
// pixel's index in an image, -1 for a dropped event.
struct JvpEvent {
  float dx, dy, w;
  int key;
};

__device__ __forceinline__ JvpEvent jvp_event(const Events& ev, int64_t e, int64_t b0, int H,
                                              int W) {
  JvpEvent je{0.0f, 0.0f, 0.0f, -1};
  if (e >= ev.n) return je;
  const float x = ev.px[(b0 / ev.gx) * ev.n + e], y = ev.py[(b0 / ev.gy) * ev.n + e],
              wt = ev.w[(b0 / ev.gw) * ev.n + e];
  const float fx = floorf(x), fy = floorf(y);
  if (!in_bounds(fx, fy, wt, H, W)) return je;  // a dropped event's tangents are never read
  je.dx = x - fx;
  je.dy = y - fy;
  je.w = wt;
  je.key = (int)fy * W + (int)fx;
  return je;
}

// The event's four tap derivatives along tangent (tx, ty), in the plain
// version's operation order.
__device__ __forceinline__ void jvp_taps(const JvpEvent& je, float tx, float ty, float v[4]) {
  v[0] = je.w * (-tx * (1.0f - je.dy) - ty * (1.0f - je.dx));
  v[1] = je.w * (tx * (1.0f - je.dy) - ty * je.dx);
  v[2] = je.w * (-tx * je.dy + ty * (1.0f - je.dx));
  v[3] = je.w * (tx * je.dy + ty * je.dx);
}

__device__ __forceinline__ void jvp_add(float* img, int W, const float v[4]) {
  atomicAdd(img, v[0]);
  atomicAdd(img + 1, v[1]);
  atomicAdd(img + W, v[2]);
  atomicAdd(img + W + 1, v[3]);
}

// K3: a block of kThreadsJ * kItemsJ consecutive events, each thread
// loading kItemsJ of them (coalesced) and testing each once, for the
// tangent images of one chunk. Each warp first looks for lanes on one
// floor pixel (__match_any_sync); if no warp of the block has any, every
// thread adds its events' taps tangent by tangent straight away. Otherwise the block
// sorts its events by floor pixel (cub::BlockRadixSort on the pixel index,
// dropped events last), so that each pixel's events of the block lie on
// consecutive lanes; then, item by item and tangent by tangent, each warp
// sums each run of equal pixels by a segmented suffix sum over shuffles
// (five steps) and the run's first lane adds its four sums with one atomic
// per tap. The events' offsets and weights wait in shared memory; their
// tangents are gathered from the block's stretch of tpx and tpy.
__global__ void __launch_bounds__(kThreadsJ) vote_jvp_kernel(Events ev, Tangents tg,
                                                            float* __restrict__ out, JvpPlan pl,
                                                            int key_bits) {
  using Sort = cub::BlockRadixSort<int, kThreadsJ, kItemsJ, int>;
  __shared__ typename Sort::TempStorage tmp;
  __shared__ float3 sev[kThreadsJ * kItemsJ];
  int64_t b0, b1;
  jvp_chunk(pl, &b0, &b1);
  const int drop = pl.H * pl.W;  // above every pixel: sorted last
  const int64_t e0 = (int64_t)blockIdx.x * (kThreadsJ * kItemsJ);
  const int64_t plane = (int64_t)pl.H * pl.W;
  const int lane = threadIdx.x & 31;
  int keys[kItemsJ], local[kItemsJ];
  bool shared = false;
#pragma unroll
  for (int k = 0; k < kItemsJ; ++k) {
    local[k] = k * kThreadsJ + threadIdx.x;
    const JvpEvent je = jvp_event(ev, e0 + local[k], b0, pl.H, pl.W);
    keys[k] = je.key >= 0 ? je.key : drop;
    sev[local[k]] = make_float3(je.dx, je.dy, je.w);
    const unsigned int peers = __match_any_sync(0xffffffffu, keys[k]);  // every lane
    shared |= je.key >= 0 && __popc(peers) > 1;
  }
  if (!__syncthreads_or(shared)) {  // no pixel shared within a warp: add at once
#pragma unroll
    for (int k = 0; k < kItemsJ; ++k) {
      if (keys[k] == drop) continue;
      const float3 o = sev[local[k]];
      const JvpEvent je{o.x, o.y, o.z, keys[k]};
      const int64_t e = e0 + local[k];
      for (int64_t i = b0; i < b1; ++i) {
        float v[4];
        jvp_taps(je, tg.tpx[(i / tg.gx) * ev.n + e], tg.tpy[(i / tg.gy) * ev.n + e], v);
        jvp_add(out + i * plane + je.key, pl.W, v);
      }
    }
    return;
  }
  Sort(tmp).SortBlockedToStriped(keys, local, 0, key_bits);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItemsJ; ++k) {  // sorted item k * kThreadsJ + threadIdx.x
    const int key = keys[k];
    const bool keep = key != drop;
    if (!__any_sync(0xffffffffu, keep)) continue;  // warp-uniform
    const unsigned int peers = __match_any_sync(0xffffffffu, key);  // a run of lanes
    const int last = 31 - __clz(peers);
    const bool head = keep && __ffs(peers) - 1 == lane;
    const bool runs = __any_sync(0xffffffffu, keep && __popc(peers) > 1);
    const float3 o = sev[local[k]];
    const JvpEvent je{o.x, o.y, o.z, key};
    const int64_t e = e0 + local[k];
    for (int64_t i = b0; i < b1; ++i) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (keep) {
        jvp_taps(je, tg.tpx[(i / tg.gx) * ev.n + e], tg.tpy[(i / tg.gy) * ev.n + e], v);
      }
      if (runs) {  // warp-uniform: some run is longer than one lane
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float a = __shfl_down_sync(0xffffffffu, v[q], d);
            if (lane + d <= last) v[q] += a;
          }
        }
      }
      if (head) jvp_add(out + i * plane + key, pl.W, v);
    }
  }
}

__global__ void noop_kernel() {}

int64_t gcd64(int64_t a, int64_t b) { return b ? gcd64(b, a % b) : a; }

unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreadsG - 1) / kThreadsG);
}

}  // namespace

extern "C" {

// The SM count and the opt-in shared memory a block may take on `device`.
int iwe_device_attrs(int device, int* sm_count, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  return (int)err;
}

// Lets the shared-memory kernels (K1's P, K2's S) take up to `bytes` of
// dynamic shared memory on the current device (needed above 48 KB, once per
// device).
int iwe_allow_smem(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(vote_fwd_band_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(vote_bwd_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return (int)err;
}

// K1, one launch of `variant` (0 = G, 1 = P). px, py, w are compact
// (b / g*, n) arrays. out must be zeroed by the caller for G; P writes every
// pixel. rows, bands and smem come from the planner (unused by G). Returns
// cudaGetLastError() after the launch.
int iwe_vote_fwd(int variant, const float* px, const float* py, const float* w, int64_t gx,
                 int64_t gy, int64_t gw, float* out, int64_t b, int64_t n, int H, int W,
                 int rows, int bands, int smem, void* stream) {
  const Events ev{px, py, w, gx, gy, gw, n};
  const cudaStream_t s = (cudaStream_t)stream;
  if (b * n > 0) {
    if (variant == 0) {
      vote_fwd_g_kernel<<<blocks_for(b * n), kThreadsG, 0, s>>>(ev, out, b * n, H, W);
    } else if (variant == 1) {
      vote_fwd_band_kernel<<<(unsigned int)(b * bands), kThreadsP, smem, s>>>(ev, out, bands,
                                                                             rows, H, W);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// K2, one launch of `variant` (0 = G, 1 = S). px, py, w are compact
// (b / g*, n) arrays; dpx, dpy and dw are (b, n), dw null when no weight
// gradient is wanted. smem is S's (the planner's: the barrier and one
// image), unused by G, whose grid is a thread per event. Returns
// cudaGetLastError() after the launch.
int iwe_vote_bwd(int variant, const float* px, const float* py, const float* w, int64_t gx,
                 int64_t gy, int64_t gw, const float* g, float* dpx, float* dpy, float* dw,
                 int64_t b, int64_t n, int H, int W, int smem, void* stream) {
  const Events ev{px, py, w, gx, gy, gw, n};
  const Grads out{dpx, dpy, dw};
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = b * n;
  if (total > 0) {
    if (variant == 0) {
      const unsigned int blocks = (unsigned int)((total + kThreadsB - 1) / kThreadsB);
      const bool narrow = total < ((int64_t)1 << 31), grouped = gx > 1 || gy > 1 || gw > 1;
      if (narrow && !grouped) {
        vote_bwd_g_kernel<uint32_t, false><<<blocks, kThreadsB, 0, s>>>(ev, g, out,
                                                                        (uint32_t)total, H, W);
      } else if (narrow) {
        vote_bwd_g_kernel<uint32_t, true><<<blocks, kThreadsB, 0, s>>>(ev, g, out,
                                                                       (uint32_t)total, H, W);
      } else {
        vote_bwd_g_kernel<int64_t, true><<<blocks, kThreadsB, 0, s>>>(ev, g, out, total, H, W);
      }
    } else if (variant == 1) {
      vote_bwd_staged_kernel<<<(unsigned int)b, kThreadsS, smem, s>>>(ev, g, out, H, W);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// K3: b tangent images (out zeroed by the caller) from compact (b / g*, n)
// events and coordinate tangents, in blocks of kThreadsJ * kItemsJ events.
// Returns cudaGetLastError() after the launch.
int iwe_vote_jvp(const float* px, const float* py, const float* w, int64_t gx, int64_t gy,
                 int64_t gw, const float* tpx, const float* tpy, int64_t gtx, int64_t gty,
                 float* out, int64_t b, int64_t n, int H, int W, void* stream) {
  const Events ev{px, py, w, gx, gy, gw, n};
  const Tangents tg{tpx, tpy, gtx, gty};
  const cudaStream_t s = (cudaStream_t)stream;
  if (gx < 1 || gy < 1 || gw < 1) return (int)cudaErrorInvalidValue;
  const int64_t span = gcd64(gcd64(gx, gy), gw);  // images that read one row of each operand
  const int64_t chunks = b / span * ((span + kTangentsJ - 1) / kTangentsJ);
  if (b % span || chunks >= (1 << 16) || (int64_t)H * W >= (int64_t)1 << 30) {
    return (int)cudaErrorInvalidValue;
  }
  const JvpPlan pl{b, (int)span, (int)(span < kTangentsJ ? span : kTangentsJ), H, W};
  if (b * n > 0) {
    const dim3 grid((unsigned int)((n + kThreadsJ * kItemsJ - 1) / (kThreadsJ * kItemsJ)),
                    (unsigned int)chunks);
    int key_bits = 1;
    while (((int64_t)1 << key_bits) <= (int64_t)H * W) ++key_bits;  // the drop key H * W too
    vote_jvp_kernel<<<grid, kThreadsJ, 0, s>>>(ev, tg, out, pl, key_bits);
  }
  return (int)cudaGetLastError();
}

// An empty kernel: the least device time of any launch (chip_smoke's floor).
int iwe_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* iwe_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
