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
//   A. refine_window, one 16x16 tile of one image per block: stages t over the
//      tile and a halo of `pad` pixels that holds reflect's values (position z
//      holds pixel reflect(z)), and the tile's pair table
//      (window_common.cuh::fill_pairs: one affinity per pair of positions,
//      written once per call by refine_pairs, since the affinities depend on
//      the image only). For each tile pixel u it writes the partial sums of KL
//      and W for the tile (no float atomics) and the gradient of
//      sum_o sum_c sum_r aff*d^2 with respect to t(u): 4 sum_o aff_o(u) d_o(u),
//      because away from the edges the neighbour role's terms are minus the
//      centre role's. The pixels within pad of an edge
//      (window_common.cuh::near_edge: 4.6 % at 256x256, window 5), where
//      reflect adds preimages, are listed and taken by window_terms, a group
//      of lanes a pixel and a row of its window a lane: the gather form
//      2 sum_o aff_o(u) d_o(u) - 2 sum_o sum_{r: reflect(r+o)=u} aff_o(r) d_o(r)
//      (window_common.cuh::preimages), the transpose of the reflect fold
//      written without scatters, the affinities recomputed from the image.
//      Every load a block needs is issued before the arithmetic that uses it.
//   B. refine_update, one slice of pixels of one image per block: sums the
//      image's tile partials in a fixed order (every block the same order, so
//      every block gets the same lambda), applies the two softmax VJPs and the
//      KL gradient, and does the Adam update of X, m, v in place. Block 0 adds
//      the step's loss to the image's total.
// One launch before the steps sets X = one_hot(mask), m = v = 0 (and the loss
// sums to 0), one writes the pair tables (or v2_aff's planes); one after them
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
//               reads them instead of the pair tables and the image. The stored values are the recomputed ones bit for bit
//               (window_common.cuh::affinity), and the sums run in the same
//               order, so masks and losses equal PLAN_V1's.
//
// Bound. The function needs, per pixel and step, 6 fp32 operations for each
// of the 12 pixel pairs of a 5x5 window ((p, o) and (p + o, -o) are one pair
// inside the image) and each class swept (one at C=2), plus the softmaxes, KL
// and Adam, and its bytes are only S, the image, the mask and the output:
// operations bind it (chip_smoke.py's refine_work counts them), 0.013 ms at
// [4,256,256], 20 steps. The kernel is far from that. Recomputing both roles'
// affinities at every pixel (2K = 48 accurate expf per pixel and step, with
// the reflect and preimage arithmetic around them) filled pass A; here each
// pixel reads K = 24 affinities from the table, and only the pixels near an
// edge recompute theirs. What binds pass A now is a block's latency, not
// the card's issue rate or bandwidth (its time grows with the waves of
// blocks; PERF.md): staging (the halo's L2 loads, its softmaxes, the pair
// table's 17 KB a tile at window 5), and in the tiles with pixels near an
// edge the edge phase, which the lane groups keep short. One launch a step instead of
// two (pass B fused into the next pass A, the halo's update done again by
// every block) was slower on an H100: the redundant updates and each block's
// sum of the partials cost more than the launches they saved.
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
  int* edge_pixels;                   // [B][tiles]: pixels of the edge phase, or null
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
                            float* __restrict__ M, float* __restrict__ V,
                            float* __restrict__ loss_acc, int B, long n) {
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i < B) loss_acc[i] = 0.f;
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

// The pair table (window_common.cuh::fill_pairs) of every tile, once before
// the steps: pairs[b][tile] holds Window<PAD>::PAIRS floats, over the tile and
// a halo that holds reflect's values.
template <int PAD>
__global__ void __launch_bounds__(THREADS)
refine_pairs(const float* __restrict__ img, float* __restrict__ pairs, const Params p) {
  __shared__ float s_img[3][HALO][HALO];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ty0 = (tile / p.tiles_x) * TILE, tx0 = (tile % p.tiles_x) * TILE;
  const int oy = ty0 - PAD, ox = tx0 - PAD, hs = TILE + 2 * PAD;
  const float* im = img + static_cast<long>(b) * p.H * p.W * 3;
  for (int i = threadIdx.x; i < hs * hs; i += THREADS) {
    const int hy = i / hs, hx = i % hs;
    const int y = wsdl::reflect_reach(oy + hy, p.H), x = wsdl::reflect_reach(ox + hx, p.W);
    const long pix = static_cast<long>(y) * p.W + x;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s_img[ch][hy][hx] = y < 0 || x < 0 ? 0.f : im[pix * 3 + ch];
  }
  __syncthreads();
  wsdl::fill_pairs<PAD>(s_img, pairs + (static_cast<long>(b) * p.tiles + tile) *
                                           wsdl::Window<PAD>::PAIRS,
                        p.spatial, p.inv2sc);
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
  __device__ __forceinline__ float pair(int k, int, int) const { return centre(k, 0.f, 0, 0); }
};

// Pass A's shared memory, floats: t over the tile and its halo, the image
// there (none with PLANES), the tile's pair table (none with PLANES: the
// planes hold every affinity), the block sum's scratch; then the edge phase's
// pixel list and its count (ints).
template <int C, int PAD, bool SYM, bool PLANES>
struct WindowSmem {
  static constexpr int NC = SYM ? 1 : C;  // classes swept
  static constexpr int NI = PLANES ? 0 : 3;
  static constexpr int PAIRS = PLANES ? 0 : wsdl::Window<PAD>::PAIRS;
  static constexpr int FLOATS = (NC + NI) * HALO * HALO + PAIRS + THREADS / 32;
  static constexpr size_t BYTES = sizeof(float) * FLOATS + sizeof(int) * (THREADS + 1);
};

// The image's lambda from its tile partials [tiles][2], summed by the whole
// block in the same order by every block (s_red: block_sum's scratch); the
// block that passes loss_acc adds the step's loss there. Ends in a barrier.
__device__ __forceinline__ float image_lambda(const float* __restrict__ part, const Params& p,
                                              float* s_red, float* s_lam, float* loss_acc) {
  float kl = 0.f, wsum = 0.f;
  for (int i = threadIdx.x; i < p.tiles; i += blockDim.x) {
    kl += part[2 * i];
    wsum += part[2 * i + 1];
  }
  kl = wsdl::block_sum(kl, s_red);
  wsum = wsdl::block_sum(wsum, s_red);
  if (threadIdx.x == 0) {
    const float w = wsum * p.normW;
    const float lam = p.lambda_b * kl / (w + 1e-6f);
    *s_lam = lam;
    if (loss_acc != nullptr) *loss_acc += kl + lam * w;
  }
  __syncthreads();
  return *s_lam;
}

// Pass B's arithmetic for one pixel: the two softmax VJPs and the KL gradient
// of g = G * scale (d loss / d t), then the Adam step of x, m, v in place.
template <int C>
__device__ __forceinline__ void adam_pixel(float* xv, float* m, float* v, const float* G,
                                           const float* S, float scale, const Params& p) {
  float q[C], g[C];
  softmax<C>(xv, q);
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = G[c] * scale;  // dloss/dt
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
    g[c] -= S[c] / (q[c] + 1e-8f);  // dKL/dq
    dot += q[c] * g[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float gx = q[c] * (g[c] - dot);  // through q = softmax(X)
    m[c] = B1 * m[c] + OMB1 * gx;
    v[c] = B2 * v[c] + OMB2 * (gx * gx);
    xv[c] = xv[c] - p.lr * ((m[c] / p.bc1) / (sqrtf(v[c] / p.bc2) + EPS));
  }
}

// Pass A. SYM: sweep class 0 alone (C == 2). PLANES: `aff` holds
// refine_affinity's planes; else it holds refine_pairs' tables. t (and the
// image) are staged over the tile and a halo that holds reflect's values, so
// every pixel takes centre_terms: the W sum and the centre role from one
// affinity per pixel pair (the tile's table, or the planes), and the gradient
// 4 sum_o aff_o(u) d_o(u) (window_common.cuh::near_edge). The pixels within
// pad of an edge, where reflect adds preimages, are then listed and taken by
// window_terms, a group of lanes each, one row of the window a lane (the
// image's affinities recomputed, or the planes read), for the gradient
// 2 (gc - gn). Every load is issued before the arithmetic that uses it: the
// pair table by cp.async first, then the pixel's X and S, then the halo's X.
template <int C, int PAD, bool SYM, bool PLANES>
__global__ void __launch_bounds__(THREADS)
refine_window(const float* __restrict__ X, const float* __restrict__ S,
              const float* __restrict__ img, const float* __restrict__ aff,
              float* __restrict__ G, float* __restrict__ part, const Params p) {
  using Smem = WindowSmem<C, PAD, SYM, PLANES>;
  constexpr int NC = Smem::NC;
  extern __shared__ float smem[];
  float(*s_t)[HALO][HALO] = reinterpret_cast<float(*)[HALO][HALO]>(smem);
  float(*s_img)[HALO][HALO] = s_t + NC;
  float* s_pair = smem + (NC + Smem::NI) * HALO * HALO;
  float* s_red = s_pair + Smem::PAIRS;
  int* s_edge = reinterpret_cast<int*>(smem + Smem::FLOATS);  // the edge phase's pixels
  int* s_nedge = s_edge + THREADS;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ty0 = (tile / p.tiles_x) * TILE, tx0 = (tile % p.tiles_x) * TILE;
  const int H = p.H, W = p.W;
  const long hw = static_cast<long>(H) * W;
  const long base = b * hw;
  const bool edges = !wsdl::interior_tile(ty0, tx0, H, W, PAD);  // pixels near an edge

  if constexpr (!PLANES) {
    const float4* src = reinterpret_cast<const float4*>(
        aff + (static_cast<long>(b) * p.tiles + tile) * wsdl::Window<PAD>::PAIRS);
    float4* dst = reinterpret_cast<float4*>(s_pair);
    for (int i = threadIdx.x; i < wsdl::Window<PAD>::PAIRS / 4; i += THREADS)
      wsdl::cp_async16(dst + i, src + i);
  }
  const int y = ty0 + threadIdx.x / TILE, x = tx0 + threadIdx.x % TILE;
  const bool inside = y < H && x < W;
  const long pix = base + static_cast<long>(y) * W + x;
  float xu[C], su[C];  // this pixel's X and S, for KL
#pragma unroll
  for (int c = 0; c < C; ++c) {
    xu[c] = inside ? X[pix * C + c] : 0.f;
    su[c] = inside ? S[pix * C + c] : 0.f;
  }
  if (threadIdx.x == 0) *s_nedge = 0;

  // t over the tile and its halo (shared coordinates: image coordinate -
  // origin), position z holding pixel reflect(z)
  const int oy = ty0 - PAD, ox = tx0 - PAD;
  constexpr int HS = TILE + 2 * PAD, PER_THREAD = (HS * HS + THREADS - 1) / THREADS;
  long src[PER_THREAD];
  float xs[PER_THREAD][C];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int sy = wsdl::reflect_reach(oy + i / HS, H), sx = wsdl::reflect_reach(ox + i % HS, W);
    src[j] = i < HS * HS && sy >= 0 && sx >= 0 ? base + static_cast<long>(sy) * W + sx : -1;
#pragma unroll
    for (int c = 0; c < C; ++c) xs[j][c] = src[j] < 0 ? 0.f : X[src[j] * C + c];
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (src[j] < 0) continue;
    const int i = threadIdx.x + j * THREADS;
    const int hy = i / HS, hx = i % HS;
    float q[C];
    softmax<C>(xs[j], q);
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
      if (edges) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) s_img[ch][hy][hx] = img[src[j] * 3 + ch];
      }
    }
  }
  wsdl::cp_async_wait_all();
  __syncthreads();

  // the gradient of the pixel at `at` from gc (and gn)
  const auto write_g = [&](long at, const float* gc, const float* gn, float k) {
    float g[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) g[c] = k * (gn == nullptr ? gc[c] : gc[c] - gn[c]);
    if constexpr (SYM) {
      G[at * C] = g[0];
      G[at * C + 1] = -g[0];
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) G[at * C + c] = g[c];
    }
  };
  float kl = 0.f, wsum = 0.f;
  if (inside) {
    float q[C], gc[NC];
    softmax<C>(xu, q);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float s = su[c];
      const float plogp = s > 0.f ? s * logf(s) : 0.f;
      kl += plogp - s * logf(q[c] + 1e-8f);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) gc[c] = 0.f;
    if constexpr (PLANES) {
      const PlaneAffinity planes{aff + static_cast<long>(b) * p.K * hw, hw, W, y, x};
      wsdl::centre_terms<PAD, NC, true>(s_t, NC, y - oy, x - ox, planes, wsum, gc);
    } else {
      const wsdl::PairAffinity<PAD> pairs{s_pair, y - ty0, x - tx0};
      wsdl::centre_terms<PAD, NC, true>(s_t, NC, y - oy, x - ox, pairs, wsum, gc);
    }
    if (edges && wsdl::near_edge(y, x, H, W, PAD))
      s_edge[atomicAdd(s_nedge, 1)] = threadIdx.x;  // any order: pixels are independent
    else
      write_g(pix, gc, nullptr, 4.f);
  }
  if (edges) {
    __syncthreads();
    // The listed pixels, spread over the whole block: WIN lanes of a warp take
    // one pixel, a row of its window each, and the rows' sums are added in row
    // order by shuffles.
    constexpr int WIN = 2 * PAD + 1, GROUPS = 32 / WIN, STRIDE = THREADS / 32 * GROUPS;
    const int lane = threadIdx.x % 32, first = lane / WIN * WIN;
    const int slot = threadIdx.x / 32 * GROUPS + lane / WIN;
    const int n = *s_nedge;
    for (int i0 = 0; i0 < n; i0 += STRIDE) {  // the same trips in every lane (shuffles)
      const int i = i0 + slot;
      const int at = lane < GROUPS * WIN && i < n ? s_edge[i] : -1;
      const int ey = ty0 + at / TILE, ex = tx0 + at % TILE;
      const bool mine = at >= 0 && ey < H && ex < W;
      float gc[NC], gn[NC], w = 0.f;  // w: the W sum's terms, counted by centre_terms
#pragma unroll
      for (int c = 0; c < NC; ++c) gc[c] = gn[c] = 0.f;
      if (mine) {
        const int dy = lane - first - PAD;  // this lane's row of the window
        if constexpr (PLANES) {
          const PlaneAffinity planes{aff + static_cast<long>(b) * p.K * hw, hw, W, ey, ex};
          wsdl::window_terms<NC, true>(s_t, NC, ey, ex, H, W, PAD, oy, ox, p.spatial, planes,
                                       dy, dy, w, gc, gn);
        } else {
          const int uy = ey - oy, ux = ex - ox;
          const wsdl::TileAffinity recompute{s_img, oy, ox, s_img[0][uy][ux], s_img[1][uy][ux],
                                             s_img[2][uy][ux], p.inv2sc};
          wsdl::window_terms<NC, true>(s_t, NC, ey, ex, H, W, PAD, oy, ox, p.spatial, recompute,
                                       dy, dy, w, gc, gn);
        }
      }
      float gct[NC], gnt[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        gct[c] = gnt[c] = 0.f;
#pragma unroll
        for (int r = 0; r < WIN; ++r) {
          gct[c] += __shfl_sync(0xffffffffu, gc[c], min(first + r, 31));
          gnt[c] += __shfl_sync(0xffffffffu, gn[c], min(first + r, 31));
        }
      }
      if (mine && lane == first) write_g(base + static_cast<long>(ey) * W + ex, gct, gnt, 2.f);
    }
  }
  if constexpr (SYM) wsum += wsum;  // class 1's share: exact, so the tile sums double exactly too
  const float kl_tile = wsdl::block_sum(kl, s_red);
  const float w_tile = wsdl::block_sum(wsum, s_red);
  if (threadIdx.x == 0) {
    float* out = part + (static_cast<long>(b) * p.tiles + tile) * 2;
    out[0] = kl_tile;
    out[1] = w_tile;
    if (p.edge_pixels != nullptr) p.edge_pixels[static_cast<long>(b) * p.tiles + tile] = *s_nedge;
  }
}

template <int C>
__global__ void __launch_bounds__(UPDATE_THREADS)
refine_update(float* __restrict__ X, float* __restrict__ M, float* __restrict__ V,
              const float* __restrict__ G, const float* __restrict__ S,
              const float* __restrict__ partials, float* __restrict__ loss_acc,
              const Params p) {
  __shared__ float s_red[UPDATE_THREADS / 32], s_lam;
  const int b = blockIdx.y;
  const long hw = static_cast<long>(p.H) * p.W;
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  const long pix = static_cast<long>(b) * hw + i;
  // the pixel's state first, so its loads overlap the partials'
  float xv[C], m[C], v[C], g[C], sv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    xv[c] = i < hw ? X[pix * C + c] : 0.f;
    m[c] = i < hw ? M[pix * C + c] : 0.f;
    v[c] = i < hw ? V[pix * C + c] : 0.f;
    g[c] = i < hw ? G[pix * C + c] : 0.f;
    sv[c] = i < hw ? S[pix * C + c] : 0.f;
  }
  const float lam = image_lambda(partials + static_cast<long>(b) * p.tiles * 2, p, s_red, &s_lam,
                                 blockIdx.x == 0 ? loss_acc + b : nullptr);
  if (i >= hw) return;
  adam_pixel<C>(xv, m, v, g, sv, lam * p.normW, p);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    M[pix * C + c] = m[c];
    V[pix * C + c] = v[c];
    X[pix * C + c] = xv[c];
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

// Pass A's instance for the plan at this window, and its shared memory.
template <int C, int PAD>
int window_kernel(int plan, WindowKernel* kernel, size_t* smem) {
  *kernel = refine_window<C, PAD, false, false>;
  *smem = WindowSmem<C, PAD, false, false>::BYTES;
  if (plan == PLAN_V2AFF) {
    *kernel = refine_window<C, PAD, false, true>;
    *smem = WindowSmem<C, PAD, false, true>::BYTES;
  }
  if (plan == PLAN_V1SYM) {
    if constexpr (C == 2) {
      *kernel = refine_window<C, PAD, true, false>;
      *smem = WindowSmem<C, PAD, true, false>::BYTES;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // above the 48 KB a launch may take by default (window 7 at C >= 3)
  return static_cast<int>(cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem)));
}

template <int C>
int run(const float* S, const float* img, const int32_t* mask, uint8_t* out, float* state,
        float* partials, float* loss_acc, float* aff, Params p, int plan, int num_steps,
        cudaStream_t stream) {
  WindowKernel window = nullptr;
  size_t smem = 0;
  int status = static_cast<int>(cudaErrorInvalidValue);
  switch (p.pad) {
    case 1: status = window_kernel<C, 1>(plan, &window, &smem); break;
    case 2: status = window_kernel<C, 2>(plan, &window, &smem); break;
    case 3: status = window_kernel<C, 3>(plan, &window, &smem); break;
  }
  if (status != 0) return status;
  const long n = static_cast<long>(p.B) * p.H * p.W;
  float *X = state, *M = X + n * C, *V = M + n * C, *G = V + n * C;  // [B,H,W,C] each
  const int flat_blocks = static_cast<int>((n + 255) / 256);
  refine_init<C><<<flat_blocks, 256, 0, stream>>>(mask, X, M, V, loss_acc, p.B, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 image_grid(static_cast<unsigned>((static_cast<long>(p.H) * p.W +
                                               UPDATE_THREADS - 1) / UPDATE_THREADS), p.B);
  const dim3 window_grid(p.tiles, p.B);
  if (plan == PLAN_V2AFF) {
    refine_affinity<<<image_grid, UPDATE_THREADS, 0, stream>>>(img, aff, p);
  } else {
    switch (p.pad) {
      case 1: refine_pairs<1><<<window_grid, THREADS, 0, stream>>>(img, aff, p); break;
      case 2: refine_pairs<2><<<window_grid, THREADS, 0, stream>>>(img, aff, p); break;
      case 3: refine_pairs<3><<<window_grid, THREADS, 0, stream>>>(img, aff, p); break;
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  double b1t = 1.0, b2t = 1.0;
  for (int t = 0; t < num_steps; ++t) {
    b1t *= 0.9;
    b2t *= 0.999;
    p.bc1 = static_cast<float>(1.0 - b1t);
    p.bc2 = static_cast<float>(1.0 - b2t);
    window<<<window_grid, THREADS, smem, stream>>>(X, S, img, aff, G, partials, p);
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

// Floats of the `aff` scratch that wsdl_refine needs for this call: the K
// planes of each image for PLAN_V2AFF, else a pair table per tile.
extern "C" long long wsdl_refine_aff_floats(int B, int H, int W, int window, int plan) {
  const long long tiles = static_cast<long long>((W + TILE - 1) / TILE) * ((H + TILE - 1) / TILE);
  if (plan == PLAN_V2AFF) return static_cast<long long>(B) * (window * window - 1) * H * W;
  switch (window / 2) {
    case 1: return B * tiles * wsdl::Window<1>::PAIRS;
    case 2: return B * tiles * wsdl::Window<2>::PAIRS;
    case 3: return B * tiles * wsdl::Window<3>::PAIRS;
    default: return 0;
  }
}

// S [B,H,W,C] f32, img [B,H,W,3] f32, mask [B,H,W] int32 -> out [B,H,W] uint8;
// loss_acc [B] f32 gets each image's sum of step losses.
// state: 4 * B*H*W*C f32 scratch (X, m, v, G); partials: B * tiles * 2 f32
// scratch with tiles = ceil(H/16) * ceil(W/16); aff: wsdl_refine_aff_floats(...) f32 of
// scratch (the K affinity planes of PLAN_V2AFF, [B, K, H, W], or the other
// plans' pair tables, [B, tiles, pairs]). edge_pixels: null, or B * tiles
// int32 that every window pass fills with the number of pixels of each tile
// its edge phase took (0 where the tile skipped it). spatial: MAX_WIN^2 floats on the
// host, window^2 floats row-major: the spatial term of each offset (0 for
// ncut). plan: PLAN_V1, PLAN_V1SYM
// (C == 2 only) or PLAN_V2AFF. Needs 2 <= C <= 4, odd window <= 7, and H, W >
// window/2.
extern "C" int wsdl_refine(const void* S, const void* img, const void* mask, void* out,
                           void* state, void* partials, void* loss_acc, void* aff,
                           void* edge_pixels, int B, int H, int W, int C, int window, int num_steps,
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
  p.edge_pixels = static_cast<int*>(edge_pixels);
  if (p.pad < 1 || p.pad > MAX_PAD || H <= p.pad || W <= p.pad || B < 1 || plan < PLAN_V1 ||
      plan > PLAN_V2AFF || aff == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  wsdl::fill_spatial(p.spatial, spatial, p.pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Sf = static_cast<const float*>(S);
  const float* If = static_cast<const float*>(img);
  const int32_t* Mi = static_cast<const int32_t*>(mask);
  uint8_t* O = static_cast<uint8_t*>(out);
  float *St = static_cast<float*>(state), *Pf = static_cast<float*>(partials),
        *Lf = static_cast<float*>(loss_acc), *Af = static_cast<float*>(aff);
  switch (C) {
    case 2: return run<2>(Sf, If, Mi, O, St, Pf, Lf, Af, p, plan, num_steps, s);
    case 3: return run<3>(Sf, If, Mi, O, St, Pf, Lf, Af, p, plan, num_steps, s);
    case 4: return run<4>(Sf, If, Mi, O, St, Pf, Lf, Af, p, plan, num_steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
