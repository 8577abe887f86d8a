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
// More than CHUNK classes are swept in chunks of CHUNK class planes.
//   Forward: the tile and a halo of `pad` pixels of the image and of a chunk
//   of S are loaded into shared memory (clipped to the image; reflected
//   neighbours lie inside the halo), and each pixel takes its terms from
//   window_common.cuh::window_terms, its affinities recomputed for each
//   chunk. It writes one partial sum per tile; a second launch of one block
//   adds the partials in a fixed order, so there are no float atomics and two
//   launches give the same bits.
//   Backward, the gather form of the JAX kernel's slice-accumulates and
//   reflect fold (one write per pixel and class), built as refine.cu's window
//   pass: the image and S are staged over a halo that holds reflect's values,
//   the tile's pair table (window_common.cuh::fill_pairs: one affinity per
//   pair of positions) is written once for all chunks, and each pixel more
//   than pad from every edge takes 4 sum_o aff_o(u) d_o(u) from it
//   (centre_terms; the neighbour role's terms are minus the centre role's
//   there). The pixels within pad of an edge (window_common.cuh::near_edge),
//   where reflect adds preimages, are listed and spread over the block's lane
//   groups through window_terms, their affinities recomputed. Two launches
//   give the same bits.
//
// Bound. Inside the image the terms (p, o) and (p + o, -o) are one pair, so
// the function needs K/2 affinities per pixel (11 operations each) and per
// pair and class 3 (forward) or 4 (backward) operations; its bytes are S and I
// read once and, backward, the gradient written once. At [8,256,256,2],
// window 5, bytes bind both: 3.1 and 4.4 us (chip_smoke.py's window_work).
// What the design does about it: every byte is read once from device memory
// into shared memory, and the affinities are computed in registers or shared
// memory instead of stored in device memory. The forward computes every
// pair's affinity twice (K expf per pixel). The backward computes the tile's
// pairs once (K/2 per pixel, plus the halo's: about 17 at window 5) and only
// the edge pixels recompute theirs; before, every pixel recomputed both roles'
// (about 2K expf) and walked the reflect preimages.
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

// The forward's tile origin and image halo (shared coordinates: image
// coordinate - origin).
struct Tile {
  int b, tile, oy, ox, hs, y, x;
  long base;
};

__device__ __forceinline__ Tile load_tile(const float* __restrict__ img,
                                          float (*s_img)[HALO][HALO], const Params& p) {
  Tile t;
  t.tile = blockIdx.x;
  t.b = blockIdx.y;
  const int ty0 = (t.tile / p.tiles_x) * TILE, tx0 = (t.tile % p.tiles_x) * TILE;
  t.oy = ty0 - p.pad;
  t.ox = tx0 - p.pad;
  t.hs = TILE + 2 * p.pad;
  t.base = static_cast<long>(t.b) * p.H * p.W;
  t.y = ty0 + threadIdx.x / TILE;
  t.x = tx0 + threadIdx.x % TILE;
  for (int i = threadIdx.x; i < t.hs * t.hs; i += THREADS) {
    const int hy = i / t.hs, hx = i % t.hs, y = t.oy + hy, x = t.ox + hx;
    if (y < 0 || y >= p.H || x < 0 || x >= p.W) continue;
    const long pix = t.base + static_cast<long>(y) * p.W + x;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s_img[ch][hy][hx] = img[pix * 3 + ch];
  }
  return t;
}

// Classes c0 .. c0+nc-1 of S over the tile and its halo into s_p.
__device__ __forceinline__ void load_chunk(const float* __restrict__ probs,
                                           float (*s_p)[HALO][HALO], const Tile& t, int c0,
                                           int nc, const Params& p) {
  for (int i = threadIdx.x; i < t.hs * t.hs; i += THREADS) {
    const int hy = i / t.hs, hx = i % t.hs, y = t.oy + hy, x = t.ox + hx;
    if (y < 0 || y >= p.H || x < 0 || x >= p.W) continue;
    const long pix = t.base + static_cast<long>(y) * p.W + x;
    for (int c = 0; c < nc; ++c) s_p[c][hy][hx] = probs[pix * p.C + c0 + c];
  }
}

// The affinities of the block's tile pixel, recomputed from s_img.
__device__ __forceinline__ wsdl::TileAffinity tile_affinity(const float (*s_img)[HALO][HALO],
                                                            const Tile& t, const Params& p) {
  const int uy = t.y - t.oy, ux = t.x - t.ox;
  return {s_img, t.oy, t.ox, s_img[0][uy][ux], s_img[1][uy][ux], s_img[2][uy][ux], p.inv2sc};
}

__global__ void __launch_bounds__(THREADS)
window_fwd(const float* __restrict__ probs, const float* __restrict__ img,
           float* __restrict__ partials, const Params p) {
  __shared__ float s_img[3][HALO][HALO];
  __shared__ float s_p[CHUNK][HALO][HALO];
  __shared__ float s_red[THREADS / 32];
  const Tile t = load_tile(img, s_img, p);
  const bool inside = t.y < p.H && t.x < p.W;
  float wsum = 0.f;
  for (int c0 = 0; c0 < p.C; c0 += CHUNK) {
    const int nc = min(CHUNK, p.C - c0);
    __syncthreads();  // the previous chunk's reads are done
    load_chunk(probs, s_p, t, c0, nc, p);
    __syncthreads();
    if (!inside) continue;
    wsdl::window_terms<CHUNK, false>(s_p, nc, t.y, t.x, p.H, p.W, p.pad, t.oy, t.ox, p.spatial,
                                     tile_affinity(s_img, t, p), -p.pad, p.pad, wsum, nullptr,
                                     nullptr);
  }
  const float tile_sum = wsdl::block_sum(wsum, s_red);
  if (threadIdx.x == 0) partials[static_cast<long>(t.b) * p.tiles + t.tile] = tile_sum;
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

// window_bwd's shared memory, floats: the image and NC class planes of probs
// over the tile and a halo that holds reflect's values (position z holds
// pixel reflect(z)), the tile's pair table; then the edge phase's pixel list
// and its count (ints).
template <int PAD, int NC>
struct BwdSmem {
  static constexpr int FLOATS = (3 + NC) * HALO * HALO + wsdl::Window<PAD>::PAIRS;
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

  // the halo's pixels (reflect's), their colour and the first chunk's classes
  constexpr int HS = TILE + 2 * PAD, PER_THREAD = (HS * HS + THREADS - 1) / THREADS;
  long src[PER_THREAD];
  float im[PER_THREAD][3], pr[PER_THREAD][NC];
  const int nc0 = min(NC, C);
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int sy = wsdl::reflect_reach(oy + i / HS, H), sx = wsdl::reflect_reach(ox + i % HS, W);
    src[j] = i < HS * HS && sy >= 0 && sx >= 0 ? base + static_cast<long>(sy) * W + sx : -1;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) im[j][ch] = src[j] < 0 ? 0.f : img[src[j] * 3 + ch];
#pragma unroll
    for (int c = 0; c < NC; ++c) pr[j][c] = src[j] < 0 || c >= nc0 ? 0.f : probs[src[j] * C + c];
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
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i >= HS * HS) continue;
        const int hy = i / HS, hx = i % HS;
        for (int c = 0; c < nc; ++c)
          s_p[c][hy][hx] = src[j] < 0 ? 0.f : probs[src[j] * C + c0 + c];
      }
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

// window_bwd at this window and class count, its shared memory raised above
// the default 48 KB where it needs more (window 7).
template <int PAD, int NC>
cudaError_t launch_bwd_nc(const float* probs, const float* img, const float* gscale, float* grad,
                          const Params& p, cudaStream_t s) {
  constexpr size_t smem = BwdSmem<PAD, NC>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_bwd<PAD, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  window_bwd<PAD, NC><<<dim3(p.tiles, p.B), THREADS, smem, s>>>(probs, img, gscale, grad, p);
  return cudaGetLastError();
}

template <int PAD>
cudaError_t launch_bwd(const float* probs, const float* img, const float* gscale, float* grad,
                       const Params& p, cudaStream_t s) {
  switch (p.C < CHUNK ? p.C : CHUNK) {
    case 1: return launch_bwd_nc<PAD, 1>(probs, img, gscale, grad, p, s);
    case 2: return launch_bwd_nc<PAD, 2>(probs, img, gscale, grad, p, s);
    case 3: return launch_bwd_nc<PAD, 3>(probs, img, gscale, grad, p, s);
    default: return launch_bwd_nc<PAD, CHUNK>(probs, img, gscale, grad, p, s);
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  window_fwd<<<dim3(p.tiles, B), THREADS, 0, s>>>(static_cast<const float*>(probs),
                                                  static_cast<const float*>(img), part, p);
  cudaError_t err = cudaGetLastError();
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
  switch (p.pad) {
    case 1: return static_cast<int>(launch_bwd<1>(P, I, G, out, p, s));
    case 2: return static_cast<int>(launch_bwd<2>(P, I, G, out, p, s));
    case 3: return static_cast<int>(launch_bwd<3>(P, I, G, out, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
