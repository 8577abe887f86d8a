// LayerCAM fusion of one layer, for Hopper (sm_90a):
//
//     cam[b,p] = relu(sum_c relu(act[b,c,p] * grad[b,c,p]))
//     out[b,p] = (cam[b,p] - lo_b) / (hi_b - lo_b + 1e-8)
//
// with lo_b, hi_b the min and max of cam over image b's pixels p; act and grad
// are [B,C,h,w] float32 or bfloat16, both of one type (the port's NCHW
// activations and their gradients), out is [B,h,w] float32.
//
// Replaces the TPU kernel ops/pallas_cam.py::_cam_kernel of the JAX package
// (fused_cam_fusion), which takes NHWC tiles with the channels on the lanes.
//
// Design. One thread-block cluster of S CTAs per image, S chosen by the
// wrapper so that B*S CTAs fill about one wave of the card's SMs (4 at batch
// 32, at most 8). CTA r of a cluster streams channels [r*CS, (r+1)*CS) of its
// image, CS = ceil(C/S), a contiguous slice of act and grad. Threads run over
// pixel vectors (float4 where h*w % 4 == 0 and the pointers are 16-byte
// aligned, so that a vector never straddles two channels; one float
// otherwise), neighbouring threads on neighbouring addresses, and are split
// into G channel groups, each summing every G-th channel of the slice for its
// pixels with UNROLL channels' loads in flight. The groups' sums are added in
// group order into the CTA's partial in shared memory. After cluster.sync(),
// CTA r takes the r-th 1/S of the image's pixels, adds the S CTAs' partials
// in rank order through distributed shared memory (map_shared_rank) and
// applies the relu; the CTAs' minima and maxima are exchanged the same way,
// and each pixel is written once. Every sum runs in a fixed order: two
// launches give the same bits.
//
// bfloat16 inputs. Each element is widened to float32 in registers, which is
// exact, and goes through the same float32 arithmetic in the same order: the
// vector width (4 elements, 8-byte loads), the split into CTAs, pixel lanes
// and channel groups, and so every sum, are those of a float32 call at the
// same shape, so the output is bit-equal to the kernel on the float32
// upcasts (the JAX kernel upcasts before its call). Only the bytes read
// halve.
//
// Bound. Bytes: act and grad read once and the CAM written once,
// (2*C + 1)*h*w*4 bytes per image: 51 MB at [32,1024,14,14] (layer3 of the
// full-width classifier, 15.3 us at 3.35 TB/s) and 103 MB at [32,2048,14,14]
// (layer4, 30.7 us); 3 operations an element are far below the card's rate.
// In bfloat16, (4*C + 4)*h*w bytes: 7.7 us at layer3 and 15.4 us at layer4.
// What the design does about it: one block an image left 100 of the 132 SMs
// idle at batch 32, each busy SM streaming 3.2 MB alone; S CTAs an image put
// B*S SMs on the stream, with 16-byte loads and 2*UNROLL of them a thread in
// flight, and every byte is read once.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/cam_fusion.py). The entry points return a CUDA
// error code (0 on success) or a count.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 8;                    // channels a thread loads before it adds them
constexpr int MAX_CLUSTER = 8;               // the portable cluster size
constexpr int MAX_SMEM = 226 * 1024;         // dynamic bytes: the card's 227 KB for one block
                                             // less 1 KB for the static arrays below

__device__ __forceinline__ float fuse(float s, float a, float g) { return s + fmaxf(a * g, 0.f); }

__device__ __forceinline__ float4 fuse(float4 s, float4 a, float4 g) {
  return make_float4(fuse(s.x, a.x, g.x), fuse(s.y, a.y, g.y), fuse(s.z, a.z, g.z),
                     fuse(s.w, a.w, g.w));
}

template <int V>
struct Vec {
  using T = float;
  __device__ static T zero() { return 0.f; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

// V consecutive input elements, the i-th group of V, widened to float32.
template <int V, typename In>
struct Load;
template <>
struct Load<1, float> {
  __device__ static float at(const float* p, size_t i) { return p[i]; }
};
template <>
struct Load<1, __nv_bfloat16> {
  __device__ static float at(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
};
template <>
struct Load<4, float> {
  __device__ static float4 at(const float* p, size_t i) {
    return reinterpret_cast<const float4*>(p)[i];
  }
};
template <>
struct Load<4, __nv_bfloat16> {
  // one 8-byte load; element k is bits [16k, 16k + 16) of the pair, little
  // endian, and a bfloat16 is the high half of the float32 it widens to
  __device__ static float4 at(const __nv_bfloat16* p, size_t i) {
    const uint2 r = reinterpret_cast<const uint2*>(p)[i];
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
  }
};

__device__ __forceinline__ void warp_min_max(float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// grid (B * S), clusters of S, block THREADS: thread t < PT * G owns the pixel
// vectors v = t % PT (mod PT) of channel group t / PT. V elements of type In
// a vector.
template <typename In, int V>
__global__ void __launch_bounds__(THREADS)
cam_fusion(const void* __restrict__ act_in, const void* __restrict__ grad_in,
           float* __restrict__ out, int C, int HW, int S, int CS, int PT, int G) {
  using T = typename Vec<V>::T;
  const In* __restrict__ act = static_cast<const In*>(act_in);
  const In* __restrict__ grad = static_cast<const In*>(grad_in);
  extern __shared__ __align__(16) float part[];  // [G][HW]: each group's sums; then the CTA's
  __shared__ float wlo[THREADS / 32], whi[THREADS / 32];
  __shared__ float cta_lo, cta_hi, img_lo, img_hi;
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int b = blockIdx.x / S;
  const int rank = static_cast<int>(cluster.block_rank());
  const int share = (HW + S - 1) / S;  // the pixels this CTA finishes
  const int p0 = min(HW, rank * share), p1 = min(HW, p0 + share);
  if (static_cast<int>(cluster.num_blocks()) != S) {  // not launched as clusters of S
    for (int p = p0 + t; p < p1; p += THREADS) out[static_cast<size_t>(b) * HW + p] = NAN;
    return;
  }

  // each group's sums over its channels of the slice
  const int NV = HW / V;  // vectors a channel
  if (t < PT * G) {
    const int g = t / PT, c1 = min(C, (rank + 1) * CS);
    const size_t image = static_cast<size_t>(b) * C * NV;
    for (int v = t % PT; v < NV; v += PT) {
      // UNROLL channels' loads issued at once, those past the slice as
      // zeros: adding relu(0 * 0) to a sum of non-negative terms leaves its
      // bits as they are, so the last round needs no loop of its own
      T s = Vec<V>::zero();
      for (int c = rank * CS + g; c < c1; c += UNROLL * G) {
        T av[UNROLL], gv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const size_t i = image + static_cast<size_t>(c + u * G) * NV + v;
          const bool in = c + u * G < c1;
          av[u] = in ? Load<V, In>::at(act, i) : Vec<V>::zero();
          gv[u] = in ? Load<V, In>::at(grad, i) : Vec<V>::zero();
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s = fuse(s, av[u], gv[u]);
      }
      reinterpret_cast<T*>(part)[g * NV + v] = s;
    }
  }
  __syncthreads();
  // the groups' sums in group order: the CTA's partial, part[0..HW)
  for (int p = t; p < HW; p += THREADS) {
    float s = part[p];
    for (int k = 1; k < G; ++k) s += part[k * HW + p];
    part[p] = s;
  }
  cluster.sync();  // every CTA's partial is complete

  // this CTA's pixels: the S partials in rank order (no CTA reads another's
  // pixels of this range, so the result may overwrite the partial), the relu
  float lo = INFINITY, hi = -INFINITY;
  for (int p = p0 + t; p < p1; p += THREADS) {
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += cluster.map_shared_rank(part, q)[p];
    s = fmaxf(s, 0.f);
    part[p] = s;
    lo = fminf(lo, s);
    hi = fmaxf(hi, s);
  }
  warp_min_max(lo, hi);
  const int warp = t / 32, lane = t % 32;
  if (lane == 0) {
    wlo[warp] = lo;
    whi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < THREADS / 32 ? wlo[lane] : INFINITY;
    hi = lane < THREADS / 32 ? whi[lane] : -INFINITY;
    warp_min_max(lo, hi);
    if (lane == 0) {
      cta_lo = lo;
      cta_hi = hi;
    }
  }
  cluster.sync();  // every CTA's min and max are written
  if (warp == 0) {
    lo = lane < S ? *cluster.map_shared_rank(&cta_lo, lane) : INFINITY;
    hi = lane < S ? *cluster.map_shared_rank(&cta_hi, lane) : -INFINITY;
    warp_min_max(lo, hi);
    if (lane == 0) {
      img_lo = lo;
      img_hi = hi;
    }
  }
  cluster.sync();  // read by all: no CTA's shared memory is read after this
  const float scale = img_hi - img_lo + 1e-8f;
  for (int p = p0 + t; p < p1; p += THREADS)
    out[static_cast<size_t>(b) * HW + p] = (part[p] - img_lo) / scale;
}

// The launch of one call: the kernel for its vector width, the split of the
// block into pixel lanes and channel groups, and the cluster configuration.
struct Plan {
  void (*kernel)(const void*, const void*, float*, int, int, int, int, int, int);
  int vec, CS, PT, G;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
};

// vec: 4-element loads (h*w % 4 == 0 and pointers aligned to 4 elements);
// bf16: bfloat16 inputs. The split does not depend on the input type.
void make_plan(Plan& pl, bool vec, bool bf16, int B, int C, int HW, int S, void* stream) {
  pl = Plan{};
  pl.vec = vec ? 4 : 1;
  pl.kernel = bf16 ? (vec ? cam_fusion<__nv_bfloat16, 4> : cam_fusion<__nv_bfloat16, 1>)
                   : (vec ? cam_fusion<float, 4> : cam_fusion<float, 1>);
  pl.CS = (C + S - 1) / S;
  pl.PT = std::min(THREADS, HW / pl.vec);
  const int fit = MAX_SMEM / static_cast<int>(sizeof(float) * HW);
  pl.G = std::max(1, std::min({THREADS / pl.PT, pl.CS, fit}));
  pl.attr.id = cudaLaunchAttributeClusterDimension;
  pl.attr.val.clusterDim.x = S;
  pl.attr.val.clusterDim.y = 1;
  pl.attr.val.clusterDim.z = 1;
  pl.config.gridDim = dim3(static_cast<unsigned>(B) * S);
  pl.config.blockDim = dim3(THREADS);
  pl.config.dynamicSmemBytes = sizeof(float) * static_cast<size_t>(pl.G) * HW;
  pl.config.stream = static_cast<cudaStream_t>(stream);
  pl.config.attrs = &pl.attr;
  pl.config.numAttrs = 1;
}

// The clusters of the plan's shape that the card holds at once (0: it cannot
// launch them), the kernel's dynamic shared memory first raised to the most
// any plan takes (the attribute is per kernel and only an upper limit).
cudaError_t max_active_clusters(const Plan& pl, int* n) {
  const cudaError_t err =
      cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, pl.kernel, &pl.config);
}

bool valid(int B, int C, int HW, int S) {
  return B >= 1 && C >= 1 && HW >= 1 && HW <= MAX_SMEM / static_cast<int>(sizeof(float)) &&
         S >= 1 && S <= MAX_CLUSTER && static_cast<long long>(B) * S <= 0x7fffffff;
}

// For each device, input type, vector width and cluster size, the largest
// dynamic shared memory of a plan found launchable: the occupancy query runs
// once a shape.
constexpr int MAX_DEVICES = 16;  // devices past these are queried on every call
std::atomic<size_t> checked[MAX_DEVICES][2][2][MAX_CLUSTER + 1];

}  // namespace

// The clusters of S CTAs that the card holds at once for a call at (C, HW),
// with 4-element loads when vec != 0, on bfloat16 inputs when bf16 != 0: a
// count >= 0, or minus the CUDA error of the query.
extern "C" int wsdl_cam_fusion_max_clusters(int C, int HW, int S, int vec, int bf16) {
  if (!valid(1, C, HW, S) || (vec && HW % 4)) return -static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  make_plan(pl, vec != 0, bf16 != 0, 1, C, HW, S, nullptr);
  int n = 0;
  const cudaError_t err = max_active_clusters(pl, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// act, grad [B,C,h,w]: contiguous float32 (bf16 == 0) or bfloat16 (bf16 != 0)
// on the device; out [B,h,w]: contiguous float32; HW = h*w; S: the CTAs of an
// image's cluster, 1..8; stream: the cudaStream_t to launch on. Requires B >= 1, C >= 1 and HW*4 bytes within the card's
// 227 KB of shared memory (the wrapper checks HW <= 50000). Returns
// cudaErrorInvalidConfiguration if the card cannot hold one such cluster.
extern "C" int wsdl_cam_fusion(const void* act, const void* grad, void* out, int B, int C,
                               int HW, int S, int bf16, void* stream) {
  if (!valid(B, C, HW, S)) return static_cast<int>(cudaErrorInvalidValue);
  const std::uintptr_t align = bf16 ? 8 : 16;  // 4 elements
  const bool vec = HW % 4 == 0 && reinterpret_cast<std::uintptr_t>(act) % align == 0 &&
                   reinterpret_cast<std::uintptr_t>(grad) % align == 0;
  Plan pl;
  make_plan(pl, vec, bf16 != 0, B, C, HW, S, stream);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::atomic<size_t>* ok =
      device < MAX_DEVICES ? &checked[device][bf16 != 0][vec][S] : nullptr;
  if (ok == nullptr || pl.config.dynamicSmemBytes > ok->load(std::memory_order_relaxed)) {
    int n = 0;
    err = max_active_clusters(pl, &n);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (ok != nullptr) ok->store(pl.config.dynamicSmemBytes, std::memory_order_relaxed);
  }
  err = cudaLaunchKernelEx(&pl.config, pl.kernel, act, grad, static_cast<float*>(out), C, HW,
                           S, pl.CS, pl.PT, pl.G);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
