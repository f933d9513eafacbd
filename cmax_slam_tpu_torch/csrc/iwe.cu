// Bilinear vote of warped events and its VJP, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by ops/cuda_iwe.py.
//
// K1 iwe_vote_fwd replaces the Pallas forward vote of
// cmax_slam_tpu/ops/pallas_iwe.py (_fwd_impl / _fwd_kernel with _sanitize),
// and on the GPU also the XLA votes the JAX package runs instead
// (ops/scatter.py: _accumulate_dense, bilinear_accumulate_two,
// bilinear_accumulate_scatter). The TPU kernel contracts per-event hat
// matrices on the matrix unit into a VMEM-resident accumulator; here each
// thread owns one event and adds its four bilinear taps straight into the
// image with global float atomics. What bounds it on the card is atomic
// throughput to L2 (4 atomics per live event, colliding where events pile
// up on the same pixels); the event stream itself is 12 B per event. This
// first version keeps the accumulator in global memory; privatizing a
// small image in shared memory is the next step.
//
// K2 iwe_vote_bwd replaces the Pallas VJP (_vjp_bwd / _bwd_kernel_lanes
// with _hats_T). Given dL/dIWE it writes per event the bilinear gather of
// the upstream gradient (dw) and the one-sided floor derivative of the vote
// along x and y (dpx, dpy). One thread per event, four gathers, no atomics:
// it is bound by the gathers' scattered reads of g (L2 hits for the
// back-end crops and the 180x240 front-end images).
//
// Both kernels take B images of H x W and (B, N) event arrays, so one
// launch serves a vector-ladder sweep (B = 9) or the old/new split (B = 2).
// An event is dropped (and gets exactly zero gradients) unless
// 1 <= floor(px) < W-2, 1 <= floor(py) < H-2 and w != 0, which is also what
// keeps NaN and infinite coordinates out of every multiply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool in_bounds(float fx, float fy, float w, int H, int W) {
  return fx >= 1.0f && fx < (float)(W - 2) && fy >= 1.0f && fy < (float)(H - 2) &&
         w != 0.0f;
}

__global__ void vote_fwd_kernel(const float* __restrict__ px, const float* __restrict__ py,
                                const float* __restrict__ w, float* __restrict__ out,
                                int64_t total, int64_t n, int H, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float x = px[i], y = py[i], wt = w[i];
  const float fx = floorf(x), fy = floorf(y);
  if (!in_bounds(fx, fy, wt, H, W)) return;
  const float dx = x - fx, dy = y - fy;
  float* img = out + (i / n) * (int64_t)H * W + (int64_t)fy * W + (int64_t)fx;
  atomicAdd(img, wt * (1.0f - dx) * (1.0f - dy));
  atomicAdd(img + 1, wt * dx * (1.0f - dy));
  atomicAdd(img + W, wt * (1.0f - dx) * dy);
  atomicAdd(img + W + 1, wt * dx * dy);
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
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// out must be zeroed by the caller. Returns cudaGetLastError() after the launch.
int iwe_vote_fwd(const float* px, const float* py, const float* w, float* out, int64_t b,
                 int64_t n, int H, int W, void* stream) {
  const int64_t total = b * n;
  if (total > 0) {
    vote_fwd_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        px, py, w, out, total, n, H, W);
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch.
int iwe_vote_bwd(const float* px, const float* py, const float* w, const float* g,
                 float* dpx, float* dpy, float* dw, int64_t b, int64_t n, int H, int W,
                 void* stream) {
  const int64_t total = b * n;
  if (total > 0) {
    vote_bwd_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        px, py, w, g, dpx, dpy, dw, total, n, H, W);
  }
  return (int)cudaGetLastError();
}

const char* iwe_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
