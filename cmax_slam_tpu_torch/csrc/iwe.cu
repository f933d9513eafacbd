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
//   a zeroed image with global float atomics: bound by atomic throughput to
//   L2. For narrow launches (the card idles and the launch dominates) and
//   images whose rows are too wide for a band plan worth having.
//
// K2 iwe_vote_bwd replaces the Pallas VJP (_vjp_bwd / _bwd_kernel_lanes
// with _hats_T). Given dL/dIWE it writes per event the bilinear gather of
// the upstream gradient (dw) and the one-sided floor derivative of the vote
// along x and y (dpx, dpy). One thread per event, four gathers, no atomics:
// it is bound by the gathers' scattered reads of g (L2 hits for the
// back-end crops and the 180x240 front-end images).
//
// Both kernels take B images of H x W. K2 takes (B, N) event arrays; K1
// takes each of px, py and w as a compact (B / g, N) array, flat image b
// reading row b / g (g = 1 for a full operand), so weights shared by a
// ladder's rungs or coordinates shared by the old/new split are read in
// place. An event is dropped (and gets exactly zero gradients) unless
// 1 <= floor(px) < W-2, 1 <= floor(py) < H-2 and w != 0, which is also what
// keeps NaN and infinite coordinates out of every multiply. Offsets into
// images are int64: B x H x W passes 2^31 at 2048x4096 x 256.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsG = 256;
constexpr int kThreadsP = 1024;  // P: beat 512 at every shape timed on an H100 (PERF.md)
constexpr int kUnroll = 4;       // events in flight per thread in the band kernel

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

__global__ void vote_bwd_kernel(const float* __restrict__ px, const float* __restrict__ py,
                                const float* __restrict__ w, const float* __restrict__ g,
                                float* __restrict__ dpx, float* __restrict__ dpy,
                                float* __restrict__ dw, int64_t total, int64_t n, int H,
                                int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float x = px[i], y = py[i], wt = w[i];
  const float fx = floorf(x), fy = floorf(y);
  if (!in_bounds(fx, fy, wt, H, W)) {
    dpx[i] = 0.0f;
    dpy[i] = 0.0f;
    dw[i] = 0.0f;
    return;
  }
  const float dx = x - fx, dy = y - fy;
  const float* G = g + (i / n) * (int64_t)H * W + (int64_t)fy * W + (int64_t)fx;
  const float g00 = G[0], g01 = G[1], g10 = G[W], g11 = G[W + 1];
  dw[i] = (1.0f - dy) * ((1.0f - dx) * g00 + dx * g01) + dy * ((1.0f - dx) * g10 + dx * g11);
  dpx[i] = wt * ((1.0f - dy) * (g01 - g00) + dy * (g11 - g10));
  dpy[i] = wt * ((1.0f - dx) * (g10 - g00) + dx * (g11 - g01));
}

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

// Lets the band kernel take up to `bytes` of dynamic shared memory on the
// current device (needed above 48 KB, once per device).
int iwe_vote_fwd_allow_smem(int bytes) {
  return (int)cudaFuncSetAttribute(vote_fwd_band_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

// Returns cudaGetLastError() after the launch.
int iwe_vote_bwd(const float* px, const float* py, const float* w, const float* g,
                 float* dpx, float* dpy, float* dw, int64_t b, int64_t n, int H, int W,
                 void* stream) {
  const int64_t total = b * n;
  if (total > 0) {
    vote_bwd_kernel<<<blocks_for(total), kThreadsG, 0, (cudaStream_t)stream>>>(
        px, py, w, g, dpx, dpy, dw, total, n, H, W);
  }
  return (int)cudaGetLastError();
}

const char* iwe_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
