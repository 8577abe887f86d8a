// LayerCAM fusion of one layer, for Hopper (sm_90a):
//
//     cam[b,p] = relu(sum_c relu(act[b,c,p] * grad[b,c,p]))
//     out[b,p] = (cam[b,p] - lo_b) / (hi_b - lo_b + 1e-8)
//
// with lo_b, hi_b the min and max of cam over image b's pixels p; act and grad
// are [B,C,h,w] float32 (the port's NCHW activations), out is [B,h,w].
//
// Replaces the TPU kernel ops/pallas_cam.py::_cam_kernel of the JAX package
// (fused_cam_fusion), which takes NHWC tiles with the channels on the lanes.
//
// Design. One block per image. Threads run over pixels, so that at each
// channel neighbouring threads read neighbouring addresses (the channel stride
// is h*w); the block's threads are also split into G channel groups, each
// summing every G-th channel of its pixels into shared memory. The groups'
// sums are then added in a fixed order (two launches give the same bits), a
// block-wide min and max follow, and each pixel is written once.
//
// Bound. Bytes: act and grad read once and the CAM written once,
// (2*C + 1)*h*w*4 bytes per image (51 MB at [32,1024,14,14], layer3 of the
// full-width classifier). One block per image leaves most of the card idle
// at batch 32; the design keeps every byte read once and coalesced.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/cam_fusion.py). The entry point returns the CUDA
// error of its launch, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int PIXEL_LANES = 256;             // at most this many threads per channel group
constexpr int DEFAULT_SMEM = 47 * 1024;      // dynamic bytes that launch without opting in
                                             // (48 KB less the static arrays below)

__device__ __forceinline__ void warp_min_max(float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// grid (B), block (PT * G): thread t owns the pixels p = t % PT (mod PT) of
// channel group t / PT. PT is a multiple of 32.
__global__ void cam_fusion(const float* __restrict__ act, const float* __restrict__ grad,
                           float* __restrict__ out, int C, int HW, int PT, int G) {
  extern __shared__ float part[];  // [G][HW]: each group's channel sums
  __shared__ float wlo[MAX_THREADS / 32], whi[MAX_THREADS / 32];
  const int t = threadIdx.x;
  const int g = t / PT;
  const size_t base = (size_t)blockIdx.x * C * HW;
  const float* a = act + base;
  const float* gr = grad + base;

  for (int p = t % PT; p < HW; p += PT) {
    float s = 0.f;
    for (int c = g; c < C; c += G) {
      const size_t i = (size_t)c * HW + p;
      s += fmaxf(a[i] * gr[i], 0.f);
    }
    part[g * HW + p] = s;
  }
  __syncthreads();

  // the groups' sums in a fixed order; each pixel's column belongs to one thread
  float lo = INFINITY, hi = -INFINITY;
  for (int p = t; p < HW; p += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += part[k * HW + p];
    s = fmaxf(s, 0.f);
    part[p] = s;
    lo = fminf(lo, s);
    hi = fmaxf(hi, s);
  }
  warp_min_max(lo, hi);
  const int warp = t / 32, lane = t % 32, warps = blockDim.x / 32;
  if (lane == 0) {
    wlo[warp] = lo;
    whi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < warps ? wlo[lane] : INFINITY;
    hi = lane < warps ? whi[lane] : -INFINITY;
    warp_min_max(lo, hi);
    if (lane == 0) {
      wlo[0] = lo;
      whi[0] = hi;
    }
  }
  __syncthreads();
  lo = wlo[0];
  const float scale = whi[0] - lo + 1e-8f;
  float* o = out + (size_t)blockIdx.x * HW;
  for (int p = t; p < HW; p += blockDim.x) o[p] = (part[p] - lo) / scale;
}

}  // namespace

// act, grad [B,C,h,w] and out [B,h,w]: contiguous float32 on the device, with
// HW = h*w; stream: the cudaStream_t to launch on. Requires 1 <= B <= 2^31-1,
// C >= 1 and HW*4 bytes within the card's 227 KB of shared memory (the wrapper
// checks HW <= 50000).
extern "C" int wsdl_cam_fusion(const void* act, const void* grad, void* out, int B, int C,
                               int HW, void* stream) {
  const int PT = std::min(PIXEL_LANES, (HW + 31) / 32 * 32);
  const int fit = DEFAULT_SMEM / (int)(sizeof(float) * HW);  // groups that need no opt-in
  const int G = std::max(1, std::min({MAX_THREADS / PT, C, fit}));
  const size_t smem = sizeof(float) * (size_t)G * HW;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        cam_fusion, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cam_fusion<<<B, PT * G, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(act), static_cast<const float*>(grad),
      static_cast<float*>(out), C, HW, PT, G);
  return static_cast<int>(cudaGetLastError());
}
