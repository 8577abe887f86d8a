// The window-affinity sum and its gradient, for Hopper (sm_90a):
//
//     sum = sum_o sum_c sum_p aff_o(p) * (S_c(p) - S_c(reflect(p + o)))^2
//     aff_o(p) = exp(-|I(p) - I(reflect(p + o))|^2 / (2 sc^2) - spatial_o)
//     d sum / d S_c(u) = 2 sum_o aff_o(u) d_o,c(u)
//                        - 2 sum_o sum_{r: reflect(r+o)=u} aff_o(r) d_o,c(r)
//
// over the win^2-1 offsets o of an odd window (reflect: the edge is not
// repeated), S [B,H,W,C] float32 probabilities (NHWC, any C), I [B,H,W,3]
// float32; spatial_o = |o|^2 / (2 ss^2) for the boundary loss, 0 for ncut. The
// gradient with respect to I is not computed (the losses treat images as data).
//
// Replaces the TPU kernels ops/pallas_window.py::_fwd_kernel (the sum, via
// _window_sum) and ::_bwd_kernel (the gradient, via _window_sum_grad) of the
// JAX package, which custom_vjp fused_window_sum joins into one function.
//
// Design. One block per 16x16 tile of one image, one thread per tile pixel.
// Both kernels stage the image and a chunk of NC = min(C, CHUNK) class planes
// of S over the tile and a halo of pad pixels that holds reflect's values
// (halo position z holds pixel reflect(z); Halo below), issuing every global
// load before the first store to shared memory, and write the tile's pair
// table once for all chunks (window_common.cuh::fill_pairs: one affinity per
// pair of positions). More than CHUNK classes are swept in chunks, in class
// order.
//   Forward: over a reflect-valued halo the centre role is the whole window
//   sum, edges included, so every pixel inside the image takes its terms
//   from the table (centre_terms), the same sum in the same order and with
//   the same bits as window_terms; no pixel needs the reflect preimages. It
//   writes one partial sum per tile; a second launch of one block adds the
//   partials in a fixed order, so there are no float atomics and two
//   launches give the same bits.
//   Backward, the gather form of the JAX kernel's slice-accumulates and
//   reflect fold (one write per pixel and class), built as refine.cu's window
//   pass: each pixel more than pad from every edge takes 4 sum_o aff_o(u)
//   d_o(u) from the table (centre_terms; the neighbour role's terms are minus
//   the centre role's there). The pixels within pad of an edge
//   (window_common.cuh::near_edge), where reflect adds preimages, are listed
//   and spread over the block's lane groups through window_terms, their
//   affinities recomputed. Two launches give the same bits.
//
// Bound. Inside the image the terms (p, o) and (p + o, -o) are one pair, so
// the function needs K/2 affinities per pixel (11 operations each) and per
// pair and class 3 (forward) or 4 (backward) operations; its bytes are S and I
// read once and, backward, the gradient written once. At [8,256,256,2],
// window 5, bytes bind both: 3.1 and 4.4 us (chip_smoke.py's window_work).
// What the design does about it: every byte is read once from device memory
// into shared memory, and the affinities are computed once per pair of
// positions into shared memory (K/2 per pixel, plus the halo's: about 17 at
// window 5) instead of stored in device memory; only the backward's edge
// pixels recompute theirs. Both kernels stay far above the bound: an
// affinity costs an expf and its shared-memory loads, and a pair term its
// loads, so the instructions a block issues bind them (PERF.md).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/window.py). The entry points return the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>

#include "window_common.cuh"

namespace {

using wsdl::HALO;
using wsdl::MAX_PAD;
using wsdl::MAX_WIN;
using wsdl::THREADS;
using wsdl::TILE;

constexpr int CHUNK = 4;           // class planes held in shared memory at once
constexpr int SUM_THREADS = 1024;

struct Params {
  int B, H, W, C, pad, tiles_x, tiles;
  float inv2sc;                       // 1 / (2 sigma_color^2)
  float spatial[MAX_WIN * MAX_WIN];   // spatial term of offset (dy, dx), row-major
};

// Each kernel's shared memory, floats: the image and NC class planes of
// probs over the tile and its halo, then the tile's pair table.
template <int PAD, int NC>
struct TileSmem {
  static constexpr int FLOATS = (3 + NC) * HALO * HALO + wsdl::Window<PAD>::PAIRS;
};

// The image and the first NC classes of probs over the tile at (ty0 - PAD,
// tx0 - PAD) and its halo, into s_img and s_p: halo position z holds pixel
// reflect(z), and zeros past reflect's reach (which no pixel of the image
// reads). Every load is issued before the first store to shared memory. The
// pixels' indices are kept for load_chunk.
template <int PAD, int NC>
struct Halo {
  static constexpr int HS = TILE + 2 * PAD, PER_THREAD = (HS * HS + THREADS - 1) / THREADS;
  long src[PER_THREAD];

  __device__ __forceinline__ void load(const float* __restrict__ probs,
                                       const float* __restrict__ img, float (*s_img)[HALO][HALO],
                                       float (*s_p)[HALO][HALO], int oy, int ox, long base,
                                       const Params& p) {
    float im[PER_THREAD][3], pr[PER_THREAD][NC];
    const int nc0 = min(NC, p.C);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int sy = wsdl::reflect_reach(oy + i / HS, p.H);
      const int sx = wsdl::reflect_reach(ox + i % HS, p.W);
      src[j] = i < HS * HS && sy >= 0 && sx >= 0 ? base + static_cast<long>(sy) * p.W + sx : -1;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) im[j][ch] = src[j] < 0 ? 0.f : img[src[j] * 3 + ch];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        pr[j][c] = src[j] < 0 || c >= nc0 ? 0.f : probs[src[j] * p.C + c];
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= HS * HS) continue;
      const int hy = i / HS, hx = i % HS;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) s_img[ch][hy][hx] = im[j][ch];
#pragma unroll
      for (int c = 0; c < NC; ++c) s_p[c][hy][hx] = pr[j][c];
    }
  }

  // classes c0 .. c0 + nc - 1 into s_p (the caller syncs around it)
  __device__ __forceinline__ void load_chunk(const float* __restrict__ probs,
                                             float (*s_p)[HALO][HALO], int c0, int nc,
                                             int C) const {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= HS * HS) continue;
      const int hy = i / HS, hx = i % HS;
      for (int c = 0; c < nc; ++c) s_p[c][hy][hx] = src[j] < 0 ? 0.f : probs[src[j] * C + c0 + c];
    }
  }
};

// One partial sum per tile: every tile pixel inside the image adds its window
// terms from the pair table (centre_terms), chunk by chunk in class order,
// then the block's fixed-order sum. NC: the classes swept at once, min(C,
// CHUNK), a constant so that one or two classes do not pay for CHUNK.
template <int PAD, int NC>
__global__ void __launch_bounds__(THREADS)
window_fwd(const float* __restrict__ probs, const float* __restrict__ img,
           float* __restrict__ partials, const Params p) {
  extern __shared__ float smem[];
  __shared__ float s_red[THREADS / 32];
  float(*s_img)[HALO][HALO] = reinterpret_cast<float(*)[HALO][HALO]>(smem);
  float(*s_p)[HALO][HALO] = s_img + 3;
  float* s_pair = smem + (3 + NC) * HALO * HALO;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ty0 = (tile / p.tiles_x) * TILE, tx0 = (tile % p.tiles_x) * TILE;
  const int oy = ty0 - PAD, ox = tx0 - PAD;
  const int y = ty0 + threadIdx.x / TILE, x = tx0 + threadIdx.x % TILE;
  const bool inside = y < p.H && x < p.W;

  Halo<PAD, NC> halo;
  halo.load(probs, img, s_img, s_p, oy, ox, static_cast<long>(b) * p.H * p.W, p);
  __syncthreads();
  wsdl::fill_pairs<PAD>(s_img, s_pair, p.spatial, p.inv2sc);
  __syncthreads();

  const wsdl::PairAffinity<PAD> pairs{s_pair, y - ty0, x - tx0};
  float wsum = 0.f;
  for (int c0 = 0; c0 < p.C; c0 += NC) {
    const int nc = min(NC, p.C - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous chunk's reads are done
      halo.load_chunk(probs, s_p, c0, nc, p.C);
      __syncthreads();
    }
    if (inside) wsdl::centre_terms<PAD, NC, false>(s_p, nc, y - oy, x - ox, pairs, wsum, nullptr);
  }
  const float tile_sum = wsdl::block_sum(wsum, s_red);
  if (threadIdx.x == 0) partials[static_cast<long>(b) * p.tiles + tile] = tile_sum;
}

// One block: the n partials summed in a fixed order into out[0].
__global__ void __launch_bounds__(SUM_THREADS)
window_sum_partials(const float* __restrict__ partials, long n, float* __restrict__ out) {
  __shared__ float s_red[SUM_THREADS / 32];
  float s = 0.f;
  for (long i = threadIdx.x; i < n; i += SUM_THREADS) s += partials[i];
  const float total = wsdl::block_sum(s, s_red);
  if (threadIdx.x == 0) out[0] = total;
}

// window_bwd's shared memory: TileSmem, then the edge phase's pixel list and
// its count (ints).
template <int PAD, int NC>
struct BwdSmem {
  static constexpr int FLOATS = TileSmem<PAD, NC>::FLOATS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS + sizeof(int) * (THREADS + 1);
};

// grad = (d sum / d S) * gscale[0]; gscale is a device scalar (the incoming
// gradient of the sum), read once per thread. The pair table is written once
// per block, for all classes; each pixel more than PAD from every edge takes
// 4 sum_o aff_o(u) d_o(u) from it (centre_terms), and the pixels within PAD
// of an edge are listed and spread over the block, WIN lanes a pixel and a
// row of its window a lane, through window_terms (affinities recomputed from
// the image), the rows' sums added in row order by shuffles. Every load of
// the image and the first chunk is issued before the first store to shared
// memory. NC: the classes swept at once, min(C, CHUNK), a constant so that
// one or two classes do not pay for CHUNK.
template <int PAD, int NC>
__global__ void __launch_bounds__(THREADS)
window_bwd(const float* __restrict__ probs, const float* __restrict__ img,
           const float* __restrict__ gscale, float* __restrict__ grad, const Params p) {
  using Smem = BwdSmem<PAD, NC>;
  extern __shared__ float smem[];
  float(*s_img)[HALO][HALO] = reinterpret_cast<float(*)[HALO][HALO]>(smem);
  float(*s_p)[HALO][HALO] = s_img + 3;
  float* s_pair = smem + (3 + NC) * HALO * HALO;
  int* s_edge = reinterpret_cast<int*>(smem + Smem::FLOATS);  // the edge phase's pixels
  int* s_nedge = s_edge + THREADS;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ty0 = (tile / p.tiles_x) * TILE, tx0 = (tile % p.tiles_x) * TILE;
  const int H = p.H, W = p.W, C = p.C;
  const long base = static_cast<long>(b) * H * W;
  const int oy = ty0 - PAD, ox = tx0 - PAD;
  const int y = ty0 + threadIdx.x / TILE, x = tx0 + threadIdx.x % TILE;
  const bool inside = y < H && x < W;
  const float g = gscale[0];
  if (threadIdx.x == 0) *s_nedge = 0;

  Halo<PAD, NC> halo;
  halo.load(probs, img, s_img, s_p, oy, ox, base, p);
  __syncthreads();
  wsdl::fill_pairs<PAD>(s_img, s_pair, p.spatial, p.inv2sc);
  const bool edges = !wsdl::interior_tile(ty0, tx0, H, W, PAD);  // pixels near an edge
  const bool listed = edges && inside && wsdl::near_edge(y, x, H, W, PAD);
  if (listed) s_edge[atomicAdd(s_nedge, 1)] = threadIdx.x;  // any order: pixels are independent
  __syncthreads();

  const long pix = base + static_cast<long>(y) * W + x;
  for (int c0 = 0; c0 < C; c0 += NC) {
    const int nc = min(NC, C - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous chunk's reads are done
      halo.load_chunk(probs, s_p, c0, nc, C);
      __syncthreads();
    }
    if (inside && !listed) {
      float wsum = 0.f, gc[NC];  // wsum unused: the compiler drops it
#pragma unroll
      for (int c = 0; c < NC; ++c) gc[c] = 0.f;
      const wsdl::PairAffinity<PAD> pairs{s_pair, y - ty0, x - tx0};
      wsdl::centre_terms<PAD, NC, true>(s_p, nc, y - oy, x - ox, pairs, wsum, gc);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < nc) grad[pix * C + c0 + c] = 4.f * gc[c] * g;
    }
    if (!edges) continue;
    constexpr int WIN = 2 * PAD + 1, GROUPS = 32 / WIN, STRIDE = THREADS / 32 * GROUPS;
    const int lane = threadIdx.x % 32, first = lane / WIN * WIN;
    const int slot = threadIdx.x / 32 * GROUPS + lane / WIN;
    const int n = *s_nedge;
    for (int i0 = 0; i0 < n; i0 += STRIDE) {  // the same trips in every lane (shuffles)
      const int i = i0 + slot;
      const int at = lane < GROUPS * WIN && i < n ? s_edge[i] : -1;
      const int ey = ty0 + at / TILE, ex = tx0 + at % TILE;
      const bool mine = at >= 0;
      float gc[NC], gn[NC], w = 0.f;  // w unused
#pragma unroll
      for (int c = 0; c < NC; ++c) gc[c] = gn[c] = 0.f;
      if (mine) {
        const int dy = lane - first - PAD;  // this lane's row of the window
        const int uy = ey - oy, ux = ex - ox;
        const wsdl::TileAffinity recompute{s_img, oy, ox, s_img[0][uy][ux], s_img[1][uy][ux],
                                           s_img[2][uy][ux], p.inv2sc};
        wsdl::window_terms<NC, true>(s_p, nc, ey, ex, H, W, PAD, oy, ox, p.spatial, recompute,
                                     dy, dy, w, gc, gn);
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
      if (mine && lane == first) {
        const long at_pix = base + static_cast<long>(ey) * W + ex;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (c < nc) grad[at_pix * C + c0 + c] = 2.f * (gct[c] - gnt[c]) * g;
      }
    }
  }
}

template <int PAD_, int NC_>
struct Shape {
  static constexpr int PAD = PAD_, NC = NC_;
};

// f(Shape<PAD, NC>{}) at p's window and NC = min(C, CHUNK).
template <int PAD, class F>
cudaError_t by_classes(const Params& p, F& f) {
  switch (p.C < CHUNK ? p.C : CHUNK) {
    case 1: return f(Shape<PAD, 1>{});
    case 2: return f(Shape<PAD, 2>{});
    case 3: return f(Shape<PAD, 3>{});
    default: return f(Shape<PAD, CHUNK>{});
  }
}

template <class F>
cudaError_t by_shape(const Params& p, F&& f) {
  switch (p.pad) {
    case 1: return by_classes<1>(p, f);
    case 2: return by_classes<2>(p, f);
    case 3: return by_classes<3>(p, f);
    default: return cudaErrorInvalidValue;
  }
}

// One block a tile, its dynamic shared memory raised above the default 48 KB
// where it needs more (window 7).
template <class... KernelArgs, class... Args>
cudaError_t launch_tiles(void (*kernel)(KernelArgs...), size_t smem, const Params& p,
                         cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.tiles, p.B), THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

// Fills p from the arguments; false if the kernels do not take them.
bool make_params(Params& p, int B, int H, int W, int C, int window, float inv2sc,
                 const void* spatial) {
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.pad = window / 2;
  p.tiles_x = (W + TILE - 1) / TILE;
  p.tiles = p.tiles_x * ((H + TILE - 1) / TILE);
  p.inv2sc = inv2sc;
  if (window % 2 == 0 || p.pad < 1 || p.pad > MAX_PAD || H <= p.pad || W <= p.pad || B < 1 ||
      B > 65535 || C < 1)
    return false;
  wsdl::fill_spatial(p.spatial, spatial, p.pad);
  return true;
}

}  // namespace

// probs [B,H,W,C] f32, img [B,H,W,3] f32 -> out[0] = the window sum (f32).
// partials: [B * tiles] f32 scratch, tiles = ceil(H/16) * ceil(W/16). spatial:
// window^2 floats on the host, the spatial term of each offset (0 for ncut).
// Needs C >= 1, an odd window 3..7 and H, W > window/2.
extern "C" int wsdl_window_sum(const void* probs, const void* img, void* partials, void* out,
                               int B, int H, int W, int C, int window, float inv2sc,
                               const void* spatial, void* stream) {
  Params p;
  if (!make_params(p, B, H, W, C, window, inv2sc, spatial))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* P = static_cast<const float*>(probs);
  const float* I = static_cast<const float*>(img);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = by_shape(p, [&](auto shape) {
    using S = decltype(shape);
    return launch_tiles(window_fwd<S::PAD, S::NC>,
                        sizeof(float) * TileSmem<S::PAD, S::NC>::FLOATS, p, s, P, I, part, p);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  window_sum_partials<<<1, SUM_THREADS, 0, s>>>(part, static_cast<long>(B) * p.tiles,
                                                static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// probs, img as above; gscale: one f32 on the device; grad [B,H,W,C] f32 gets
// (d sum / d probs) * gscale[0].
extern "C" int wsdl_window_sum_grad(const void* probs, const void* img, const void* gscale,
                                    void* grad, int B, int H, int W, int C, int window,
                                    float inv2sc, const void* spatial, void* stream) {
  Params p;
  if (!make_params(p, B, H, W, C, window, inv2sc, spatial))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* P = static_cast<const float*>(probs);
  const float* I = static_cast<const float*>(img);
  const float* G = static_cast<const float*>(gscale);
  float* out = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_shape(p, [&](auto shape) {
    using S = decltype(shape);
    return launch_tiles(window_bwd<S::PAD, S::NC>, BwdSmem<S::PAD, S::NC>::BYTES, p, s, P, I, G,
                        out, p);
  }));
}
