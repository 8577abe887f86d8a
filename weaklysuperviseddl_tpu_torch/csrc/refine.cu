// Alternating-direction mask refinement of a batch of images, for Hopper (sm_90a).
//
// Replaces the TPU kernels ops/pallas_refine.py::_refine_kernel (plans v1 and
// v1sym) and ::_refine_kernel_v2 (plans v2 and v2_aff) of the JAX package
// (pallas_refine). For each image: X = one_hot(mask) over C channels, then
// num_steps Adam steps (beta 0.9/0.999, eps 1e-8, bias correction at step t+1) on
//     loss = KL + lambda * W,   lambda = lambda_b * KL / (W + 1e-6)  (no gradient)
//     q = softmax_C(X);  t = softmax_C(q) for ncut, t = q for boundary
//     KL = sum [s>0] s log s - s log(q + 1e-8)
//     W  = normW * sum_o sum_c sum_r aff_o(r) * (t_c(r) - t_c(reflect(r + o)))^2
//     aff_o(r) = exp(-|I(r) - I(reflect(r + o))|^2 / (2 sc^2) - spatial_o)
// over the win^2-1 offsets o of the window (reflect: the edge is not repeated),
// and finally mask = softmax(X)[1] > threshold.
//
// Design. The TPU program keeps one image's whole state in VMEM (X, m, v alone
// are 1.5 MB at 256x256, C=2); a block here has at most 227 KB of shared memory,
// and a step needs two image-wide sums (KL and W) before the gradient scale
// lambda is known. So the state lives in global scratch (X, m, v and the
// unscaled window gradient G, [B,H,W,C] float each: 8 MB at [4,256,256,2], which
// stays in the 50 MB L2), and each step is two launches:
//   A. refine_window, one 16x16 tile of one image per block: loads X and the
//      image over the tile and a halo of `pad` pixels (clipped to the image)
//      into shared memory, computes t there, and for each tile pixel u writes
//      the partial sums of KL and W for the tile (no float atomics) and the
//      gradient of sum_o sum_c sum_r aff*d^2 with respect to t(u), in gather
//      form: 2 sum_o aff_o(u) d_o(u) - 2 sum_o sum_{r: reflect(r+o)=u}
//      aff_o(r) d_o(r) (window_common.cuh::preimages). This is the transpose
//      of the reflect fold, written without scatters.
//   B. refine_update, one slice of pixels of one image per block: sums the
//      image's tile partials in a fixed order (every block the same order, so
//      every block gets the same lambda), applies the two softmax VJPs and the
//      KL gradient, and does the Adam update of X, m, v in place. Block 0 adds
//      the step's loss to the image's total.
// One launch before the steps sets X = one_hot(mask), m = v = 0; one after them
// writes the mask. Nothing depends on the order blocks run in, so two runs give
// identical bits. expf/logf/sqrtf, no fast-math.
//
// Plans (the `plan` argument; ops/refine.py maps the TPU's names onto them):
//   PLAN_V1     every class swept in pass A. The TPU's v2 differs from its v1
//               only in writing the window backward as gathers instead of
//               scatter-accumulates; pass A is already that gather, so v2 runs
//               this plan.
//   PLAN_V1SYM  C=2 only: t_0 + t_1 = 1, so d_1 = -d_0 and aff*d_1^2 =
//               aff*d_0^2. Pass A sweeps class 0 alone, doubles the W sum and
//               writes g_1 = -g_0 (the TPU's v1sym, exact up to the ~1-ulp error
//               of the softmax channels' sum). Pass B is unchanged.
//   PLAN_V2AFF  the affinities depend on the image only: one launch before the
//               steps (refine_affinity) writes the K planes of each image,
//               [B,K,H,W] float (25 MB at [4,256,256], window 5), and pass A
//               reads them instead of calling expf about 50 times per pixel and
//               step, and needs no image in shared memory. The stored values are
//               the recomputed ones bit for bit (window_common.cuh::affinity),
//               and the sums run in the same order, so masks and losses equal
//               PLAN_V1's.
//
// Bound. The function needs, per pixel and step, 6 fp32 operations for each
// of the 12 pixel pairs of a 5x5 window ((p, o) and (p + o, -o) are one pair
// inside the image) and each class swept (one at C=2), plus the softmaxes, KL
// and Adam, and its bytes are only S, the image, the mask and the output:
// operations bind it (chip_smoke.py's refine_work counts them). What the design does about it: the state stays in
// L2 (about 27 MB of traffic a step at [4,256,256], C=2), the 2*num_steps+2
// launches need no host round trip, PLAN_V1SYM halves pass A's sweep, and
// PLAN_V2AFF trades the recomputed affinities for L2 reads of stored planes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/refine.py). The entry point returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_common.cuh"

namespace {

using wsdl::HALO;
using wsdl::MAX_PAD;
using wsdl::MAX_WIN;
using wsdl::THREADS;
using wsdl::TILE;

constexpr int UPDATE_THREADS = 256;
constexpr float B1 = 0.9f, B2 = 0.999f, EPS = 1e-8f;
// (1 - beta) rounded once from double, as optax and the plain version round it
constexpr float OMB1 = static_cast<float>(1.0 - 0.9);
constexpr float OMB2 = static_cast<float>(1.0 - 0.999);

enum Plan { PLAN_V1 = 0, PLAN_V1SYM = 1, PLAN_V2AFF = 2 };

struct Params {
  int B, H, W, pad, K, tiles_x, tiles;
  int double_softmax;
  float inv2sc;                       // 1 / (2 sigma_color^2)
  float normW, lambda_b, lr, threshold;
  float bc1, bc2;                     // Adam bias corrections of this step
  float spatial[MAX_WIN * MAX_WIN];   // spatial term of offset (dy, dx), row-major
};

template <int C>
__device__ __forceinline__ void softmax(const float* x, float* out) {
  float mx = x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) mx = fmaxf(mx, x[c]);
  float e[C];
  float tot = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    e[c] = expf(x[c] - mx);
    tot += e[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = e[c] / tot;
}

template <int C>
__global__ void refine_init(const int32_t* __restrict__ mask, float* __restrict__ X,
                            float* __restrict__ M, float* __restrict__ V, long n) {
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const int label = mask[i];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    X[i * C + c] = label == c ? 1.f : 0.f;
    M[i * C + c] = 0.f;
    V[i * C + c] = 0.f;
  }
}

// The K affinity planes of each image: aff[b][k][r] = aff_{o_k}(r), offsets o_k
// row-major with the centre left out.
__global__ void refine_affinity(const float* __restrict__ img, float* __restrict__ aff,
                                const Params p) {
  const long hw = static_cast<long>(p.H) * p.W;
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i >= hw) return;
  const int b = blockIdx.y, y = static_cast<int>(i / p.W), x = static_cast<int>(i % p.W);
  const float* im = img + static_cast<long>(b) * hw * 3;
  const float i0 = im[i * 3], i1 = im[i * 3 + 1], i2 = im[i * 3 + 2];
  float* out = aff + static_cast<long>(b) * p.K * hw + i;
  int k = 0;
  for (int dy = -p.pad; dy <= p.pad; ++dy) {
    const int ny = wsdl::reflect(y + dy, p.H);
    for (int dx = -p.pad; dx <= p.pad; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const long n = static_cast<long>(ny) * p.W + wsdl::reflect(x + dx, p.W);
      out[k * hw] = wsdl::affinity(i0 - im[n * 3], i1 - im[n * 3 + 1], i2 - im[n * 3 + 2],
                                   p.inv2sc, p.spatial[(dy + MAX_PAD) * MAX_WIN + dx + MAX_PAD]);
      ++k;
    }
  }
}

// Affinities read from one image's planes (refine_affinity's), for tile pixel
// u = (y, x): aff_{o_k}(r) is plane k at r.
struct PlaneAffinity {
  const float* aff;  // [K][H][W]
  long hw;
  int W, y, x;
  __device__ __forceinline__ float centre(int k, float, int, int) const {
    return aff[k * hw + static_cast<long>(y) * W + x];
  }
  __device__ __forceinline__ float neighbour(int k, float, int ry, int rx) const {
    return aff[k * hw + static_cast<long>(ry) * W + rx];
  }
};

// Pass A. SYM: sweep class 0 alone (C == 2). PLANES: read the affinities from
// `aff` (refine_affinity's planes) instead of computing them from the image.
// One pixel's window terms come from window_common.cuh::window_terms, as in
// window.cu's kernels.
template <int C, bool SYM, bool PLANES>
__global__ void __launch_bounds__(THREADS)
refine_window(const float* __restrict__ X, const float* __restrict__ S,
              const float* __restrict__ img, const float* __restrict__ aff,
              float* __restrict__ G, float* __restrict__ partials, const Params p) {
  constexpr int NC = SYM ? 1 : C;         // classes swept
  constexpr int NI = PLANES ? 1 : 3;      // image channels held (none read with PLANES)
  __shared__ float s_t[NC][HALO][HALO];
  __shared__ float s_img[NI][HALO][HALO];
  __shared__ float s_red[THREADS / 32];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ty0 = (tile / p.tiles_x) * TILE, tx0 = (tile % p.tiles_x) * TILE;
  const int H = p.H, W = p.W, pad = p.pad;
  const long hw = static_cast<long>(H) * W;
  const long base = b * hw;

  // t over the tile and its halo (shared coordinates: image coordinate - origin)
  const int oy = ty0 - pad, ox = tx0 - pad, hs = TILE + 2 * pad;
  for (int i = threadIdx.x; i < hs * hs; i += THREADS) {
    const int hy = i / hs, hx = i % hs, y = oy + hy, x = ox + hx;
    if (y < 0 || y >= H || x < 0 || x >= W) continue;
    const long pix = base + static_cast<long>(y) * W + x;
    float xv[C], q[C];
#pragma unroll
    for (int c = 0; c < C; ++c) xv[c] = X[pix * C + c];
    softmax<C>(xv, q);
    if (p.double_softmax) {
      float t[C];
      softmax<C>(q, t);
#pragma unroll
      for (int c = 0; c < NC; ++c) s_t[c][hy][hx] = t[c];
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) s_t[c][hy][hx] = q[c];
    }
    if constexpr (!PLANES) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s_img[ch][hy][hx] = img[pix * 3 + ch];
    }
  }
  __syncthreads();

  const int y = ty0 + threadIdx.x / TILE, x = tx0 + threadIdx.x % TILE;
  float kl = 0.f, wsum = 0.f;
  if (y < H && x < W) {
    const long pix = base + static_cast<long>(y) * W + x;
    float xv[C], q[C], gc[NC], gn[NC];
#pragma unroll
    for (int c = 0; c < C; ++c) xv[c] = X[pix * C + c];
    softmax<C>(xv, q);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float s = S[pix * C + c];
      const float plogp = s > 0.f ? s * logf(s) : 0.f;
      kl += plogp - s * logf(q[c] + 1e-8f);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) gc[c] = gn[c] = 0.f;
    if constexpr (PLANES) {
      const PlaneAffinity planes{aff + static_cast<long>(b) * p.K * hw, hw, W, y, x};
      wsdl::window_terms<NC, true>(s_t, NC, y, x, H, W, pad, oy, ox, p.spatial, planes, wsum, gc,
                                   gn);
    } else {
      const int uy = y - oy, ux = x - ox;
      const wsdl::TileAffinity recompute{s_img, oy, ox, s_img[0][uy][ux], s_img[1][uy][ux],
                                         s_img[2][uy][ux], p.inv2sc};
      wsdl::window_terms<NC, true>(s_t, NC, y, x, H, W, pad, oy, ox, p.spatial, recompute, wsum,
                                   gc, gn);
    }
    if constexpr (SYM) {
      const float g0 = 2.f * (gc[0] - gn[0]);
      G[pix * C] = g0;
      G[pix * C + 1] = -g0;
      wsum += wsum;  // class 1's share: exact, so the tile sums double exactly too
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) G[pix * C + c] = 2.f * (gc[c] - gn[c]);
    }
  }
  const float kl_tile = wsdl::block_sum(kl, s_red);
  const float w_tile = wsdl::block_sum(wsum, s_red);
  if (threadIdx.x == 0) {
    float* out = partials + (static_cast<long>(b) * p.tiles + tile) * 2;
    out[0] = kl_tile;
    out[1] = w_tile;
  }
}

template <int C>
__global__ void __launch_bounds__(UPDATE_THREADS)
refine_update(float* __restrict__ X, float* __restrict__ M, float* __restrict__ V,
              const float* __restrict__ G, const float* __restrict__ S,
              const float* __restrict__ partials, float* __restrict__ loss_acc,
              const Params p) {
  __shared__ float s_lam;
  const int b = blockIdx.y;
  if (threadIdx.x < 32) {
    // the image's tile partials, summed in the same order by every block
    const float* part = partials + static_cast<long>(b) * p.tiles * 2;
    float kl = 0.f, wsum = 0.f;
    for (int i = threadIdx.x; i < p.tiles; i += 32) {
      kl += part[2 * i];
      wsum += part[2 * i + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kl += __shfl_down_sync(0xffffffffu, kl, off);
      wsum += __shfl_down_sync(0xffffffffu, wsum, off);
    }
    if (threadIdx.x == 0) {
      const float w = wsum * p.normW;
      const float lam = p.lambda_b * kl / (w + 1e-6f);
      s_lam = lam;
      if (blockIdx.x == 0) loss_acc[b] += kl + lam * w;
    }
  }
  __syncthreads();
  const long hw = static_cast<long>(p.H) * p.W;
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i >= hw) return;
  const long pix = static_cast<long>(b) * hw + i;
  const float scale = s_lam * p.normW;
  float xv[C], q[C], g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xv[c] = X[pix * C + c];
  softmax<C>(xv, q);
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = G[pix * C + c] * scale;  // dloss/dt
  if (p.double_softmax) {  // through t = softmax(q)
    float t[C];
    softmax<C>(q, t);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) dot += t[c] * g[c];
#pragma unroll
    for (int c = 0; c < C; ++c) g[c] = t[c] * (g[c] - dot);
  }
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    g[c] -= S[pix * C + c] / (q[c] + 1e-8f);  // dKL/dq
    dot += q[c] * g[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float gx = q[c] * (g[c] - dot);  // through q = softmax(X)
    const float m = B1 * M[pix * C + c] + OMB1 * gx;
    const float v = B2 * V[pix * C + c] + OMB2 * (gx * gx);
    M[pix * C + c] = m;
    V[pix * C + c] = v;
    X[pix * C + c] = xv[c] - p.lr * ((m / p.bc1) / (sqrtf(v / p.bc2) + EPS));
  }
}

template <int C>
__global__ void refine_threshold(const float* __restrict__ X, uint8_t* __restrict__ out,
                                 float threshold, long n) {
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  float xv[C], q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xv[c] = X[i * C + c];
  softmax<C>(xv, q);
  out[i] = q[1] > threshold ? 1 : 0;
}

using WindowKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                              float*, const Params);

template <int C>
int run(const float* S, const float* img, const int32_t* mask, uint8_t* out, float* X,
        float* M, float* V, float* G, float* partials, float* loss_acc, float* aff, Params p,
        int plan, int num_steps, cudaStream_t stream) {
  WindowKernel window = refine_window<C, false, false>;
  if (plan == PLAN_V2AFF) window = refine_window<C, false, true>;
  if constexpr (C == 2) {
    if (plan == PLAN_V1SYM) window = refine_window<2, true, false>;
  } else {
    if (plan == PLAN_V1SYM) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long n = static_cast<long>(p.B) * p.H * p.W;
  const int flat_blocks = static_cast<int>((n + 255) / 256);
  refine_init<C><<<flat_blocks, 256, 0, stream>>>(mask, X, M, V, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 image_grid(static_cast<unsigned>((static_cast<long>(p.H) * p.W +
                                               UPDATE_THREADS - 1) / UPDATE_THREADS), p.B);
  if (plan == PLAN_V2AFF) {
    refine_affinity<<<image_grid, UPDATE_THREADS, 0, stream>>>(img, aff, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 window_grid(p.tiles, p.B);
  double b1t = 1.0, b2t = 1.0;
  for (int t = 0; t < num_steps; ++t) {
    b1t *= 0.9;
    b2t *= 0.999;
    p.bc1 = static_cast<float>(1.0 - b1t);
    p.bc2 = static_cast<float>(1.0 - b2t);
    window<<<window_grid, THREADS, 0, stream>>>(X, S, img, aff, G, partials, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    refine_update<C><<<image_grid, UPDATE_THREADS, 0, stream>>>(X, M, V, G, S, partials,
                                                                loss_acc, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  refine_threshold<C><<<flat_blocks, 256, 0, stream>>>(X, out, p.threshold, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S [B,H,W,C] f32, img [B,H,W,3] f32, mask [B,H,W] int32 -> out [B,H,W] uint8;
// loss_acc [B] f32 (zeroed by the caller) gets each image's sum of step losses.
// X, M, V, G: [B,H,W,C] f32 scratch; partials: [B, tiles, 2] f32 scratch with
// tiles = ceil(H/16) * ceil(W/16); aff: [B, window^2 - 1, H, W] f32 scratch for
// PLAN_V2AFF, unused (may be null) otherwise. spatial: MAX_WIN^2 floats on the
// host, window^2 floats row-major: the spatial term of each offset (0 for
// ncut). plan: PLAN_V1, PLAN_V1SYM
// (C == 2 only) or PLAN_V2AFF. Needs 2 <= C <= 4, odd window <= 7, and H, W >
// window/2.
extern "C" int wsdl_refine(const void* S, const void* img, const void* mask, void* out,
                           void* X, void* M, void* V, void* G, void* partials, void* loss_acc,
                           void* aff, int B, int H, int W, int C, int window, int num_steps,
                           int plan, int double_softmax, float inv2sc, float normW,
                           float lambda_b, float lr, float threshold, const void* spatial,
                           void* stream) {
  Params p;
  p.B = B;
  p.H = H;
  p.W = W;
  p.pad = window / 2;
  p.K = window * window - 1;
  p.tiles_x = (W + TILE - 1) / TILE;
  p.tiles = p.tiles_x * ((H + TILE - 1) / TILE);
  p.double_softmax = double_softmax;
  p.inv2sc = inv2sc;
  p.normW = normW;
  p.lambda_b = lambda_b;
  p.lr = lr;
  p.threshold = threshold;
  p.bc1 = p.bc2 = 1.f;
  if (p.pad < 1 || p.pad > MAX_PAD || H <= p.pad || W <= p.pad || B < 1 || plan < PLAN_V1 ||
      plan > PLAN_V2AFF || (plan == PLAN_V2AFF && aff == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  wsdl::fill_spatial(p.spatial, spatial, p.pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Sf = static_cast<const float*>(S);
  const float* If = static_cast<const float*>(img);
  const int32_t* Mi = static_cast<const int32_t*>(mask);
  uint8_t* O = static_cast<uint8_t*>(out);
  float *Xf = static_cast<float*>(X), *Mf = static_cast<float*>(M), *Vf = static_cast<float*>(V),
        *Gf = static_cast<float*>(G), *Pf = static_cast<float*>(partials),
        *Lf = static_cast<float*>(loss_acc), *Af = static_cast<float*>(aff);
  switch (C) {
    case 2: return run<2>(Sf, If, Mi, O, Xf, Mf, Vf, Gf, Pf, Lf, Af, p, plan, num_steps, s);
    case 3: return run<3>(Sf, If, Mi, O, Xf, Mf, Vf, Gf, Pf, Lf, Af, p, plan, num_steps, s);
    case 4: return run<4>(Sf, If, Mi, O, Xf, Mf, Vf, Gf, Pf, Lf, Af, p, plan, num_steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
