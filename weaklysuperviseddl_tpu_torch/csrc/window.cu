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
// Design. One block per 16x16 tile of one image, as refine.cu's window pass:
// the tile and a halo of `pad` pixels of the image and of up to CHUNK class
// planes are loaded into shared memory (clipped to the image; reflected
// neighbours and preimages of tile pixels lie inside the halo), one thread per
// tile pixel. The forward writes one partial sum per tile; a second launch of
// one block adds the partials in a fixed order, so there are no float atomics
// and two launches give the same bits. The backward is the gather form of the
// JAX kernel's slice-accumulates and reflect fold: one write per pixel and
// class. Both kernels take one pixel's terms from window_common.cuh::
// window_terms, as refine.cu's window pass does. More than CHUNK classes are
// swept in chunks, the affinities recomputed for each chunk.
//
// Bound. Inside the image the terms (p, o) and (p + o, -o) are one pair, so
// the function needs K/2 affinities per pixel (11 operations each) and per
// pair and class 3 (forward) or 4 (backward) operations; its bytes are S and I
// read once and, backward, the gradient written once. At [8,256,256,2],
// window 5, bytes bind both: 3.1 and 4.4 us (chip_smoke.py's window_work).
// What the design does about it: every byte is read once from device memory
// into shared memory, and the affinities are recomputed in registers instead
// of stored; each pixel computes its own terms, so the forward computes every
// pair's affinity twice and the backward four times (about 2K expf per pixel).
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

// The tile's origin and the image halo (shared coordinates: image coordinate -
// origin), loaded by every block of both kernels.
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

// grad = (d sum / d S) * gscale[0]; gscale is a device scalar (the incoming
// gradient of the sum), read once per thread.
__global__ void __launch_bounds__(THREADS)
window_bwd(const float* __restrict__ probs, const float* __restrict__ img,
           const float* __restrict__ gscale, float* __restrict__ grad, const Params p) {
  __shared__ float s_img[3][HALO][HALO];
  __shared__ float s_p[CHUNK][HALO][HALO];
  const Tile t = load_tile(img, s_img, p);
  const bool inside = t.y < p.H && t.x < p.W;
  const float g = inside ? gscale[0] : 0.f;
  for (int c0 = 0; c0 < p.C; c0 += CHUNK) {
    const int nc = min(CHUNK, p.C - c0);
    __syncthreads();  // the previous chunk's reads are done
    load_chunk(probs, s_p, t, c0, nc, p);
    __syncthreads();
    if (!inside) continue;
    float wsum = 0.f, gc[CHUNK], gn[CHUNK];  // wsum unused: the compiler drops it
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) gc[c] = gn[c] = 0.f;
    wsdl::window_terms<CHUNK, true>(s_p, nc, t.y, t.x, p.H, p.W, p.pad, t.oy, t.ox, p.spatial,
                                    tile_affinity(s_img, t, p), -p.pad, p.pad, wsum, gc, gn);
    const long pix = t.base + static_cast<long>(t.y) * p.W + t.x;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
      if (c < nc) grad[pix * p.C + c0 + c] = 2.f * (gc[c] - gn[c]) * g;
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
  window_bwd<<<dim3(p.tiles, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const float*>(img),
      static_cast<const float*>(gscale), static_cast<float*>(grad), p);
  return static_cast<int>(cudaGetLastError());
}
