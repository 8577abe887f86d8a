// Pieces shared by the window-affinity kernels (window.cu) and the refinement
// kernel (refine.cu): the tile geometry, reflect indexing and its preimages,
// the colour affinity of one pixel pair, one pixel's window sum and gradient
// (window_terms), and a fixed-order block sum.
//
// The window term of pixel r and offset o pairs r with its neighbour
// n = reflect(r + o) (jnp.pad(mode="reflect"): the edge is not repeated):
//     aff_o(r) = exp(-|I(r) - I(n)|^2 / (2 sc^2) - spatial_o)
// Every kernel computes it with affinity() below, whose products and sums are
// rounded one at a time (no fused multiply-add), so a kernel that reads stored
// affinities gets the same bits as one that recomputes them.

#pragma once

#include <cuda_runtime.h>

namespace wsdl {

constexpr int TILE = 16;                   // a tile is TILE x TILE pixels
constexpr int THREADS = TILE * TILE;       // one thread per tile pixel
constexpr int MAX_PAD = 3;                 // windows up to 7x7
constexpr int MAX_WIN = 2 * MAX_PAD + 1;
constexpr int HALO = TILE + 2 * MAX_PAD;

__device__ __forceinline__ int reflect(int z, int n) {
  return z < 0 ? -z : (z >= n ? 2 * (n - 1) - z : z);
}

// The coordinates r in [0, n) with reflect(r + d, n) == u, into out; returns
// their count. The padded position z = r + d is u itself or, at the border, the
// mirror image of u: -u (when u > 0) or 2(n-1) - u (when u < n-1). Every r lies
// within |d| <= pad of u, so a tile's halo of `pad` pixels holds it.
__device__ __forceinline__ int preimages(int u, int d, int n, int* out) {
  int k = 0;
  int r = u - d;
  if (r >= 0 && r < n) out[k++] = r;
  r = -u - d;
  if (u > 0 && r >= 0 && r < n) out[k++] = r;
  r = 2 * (n - 1) - u - d;
  if (u < n - 1 && r >= 0 && r < n) out[k++] = r;
  return k;
}

// aff for the colour difference (d0, d1, d2) = I(r) - I(n): the exponent as
// losses/window.py::affinity_exponent forms it, -(|d|^2 * inv2sc) - spatial.
__device__ __forceinline__ float affinity(float d0, float d1, float d2, float inv2sc,
                                          float spatial) {
  const float cd = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
  return expf(__fsub_rn(-__fmul_rn(cd, inv2sc), spatial));
}

// Affinities recomputed from the image over a tile and its halo in shared
// memory (s_img[ch][sy][sx], shared coordinates = image coordinates - origin),
// for tile pixel u whose colour is iu.
struct TileAffinity {
  const float (*s_img)[HALO][HALO];
  int oy, ox;
  float iu0, iu1, iu2, inv2sc;
  // aff_o(u), o the k-th offset, its neighbour at image (ny, nx)
  __device__ __forceinline__ float centre(int, float sp, int ny, int nx) const {
    const int sy = ny - oy, sx = nx - ox;
    return affinity(iu0 - s_img[0][sy][sx], iu1 - s_img[1][sy][sx], iu2 - s_img[2][sy][sx],
                    inv2sc, sp);
  }
  // aff_o(r) of a preimage r at image (ry, rx), whose offset-o neighbour is u
  __device__ __forceinline__ float neighbour(int, float sp, int ry, int rx) const {
    const int sy = ry - oy, sx = rx - ox;
    return affinity(s_img[0][sy][sx] - iu0, s_img[1][sy][sx] - iu1, s_img[2][sy][sx] - iu2,
                    inv2sc, sp);
  }
};

// The window terms of tile pixel u = (y, x), for the classes c < nc (nc <=
// NMAX) of tp, t over the tile and its halo in shared memory (shared
// coordinates = image coordinates - (oy, ox)):
//   wsum  += sum_o sum_c aff_o(u) d_o,c(u)^2,   d_o,c(r) = t_c(r) - t_c(reflect(r + o))
//   gc[c] += sum_o aff_o(u) d_o,c(u)                                  (GRAD)
//   gn[c] += sum_o sum_{r: reflect(r+o)=u} aff_o(r) d_o,c(r)           (GRAD)
// so d wsum / d t_c(u) = 2 (gc[c] - gn[c]): the gather form of the transpose
// of the reflect fold, one write per pixel, no scatters. Offsets run row-major
// without the centre (k counts them); `spatial` is laid out for MAX_WIN. aff
// gives the affinities (TileAffinity, or stored planes): every kernel of the
// window family sums in this one order.
template <int NMAX, bool GRAD, class Aff>
__device__ __forceinline__ void window_terms(const float (*tp)[HALO][HALO], int nc, int y, int x,
                                             int H, int W, int pad, int oy, int ox,
                                             const float* spatial, const Aff& aff, float& wsum,
                                             float* gc, float* gn) {
  float tu[NMAX];
#pragma unroll
  for (int c = 0; c < NMAX; ++c) tu[c] = c < nc ? tp[c][y - oy][x - ox] : 0.f;
  int k = 0;
  for (int dy = -pad; dy <= pad; ++dy) {
    const int ny = reflect(y + dy, H);
    int rows[3];
    int nr = 0;
    if constexpr (GRAD) nr = preimages(y, dy, H, rows);
    for (int dx = -pad; dx <= pad; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float sp = spatial[(dy + MAX_PAD) * MAX_WIN + dx + MAX_PAD];
      const int nx = reflect(x + dx, W);
      // centre role: r = u, neighbour reflect(u + o)
      const float a = aff.centre(k, sp, ny, nx);
#pragma unroll
      for (int c = 0; c < NMAX; ++c) {
        if (c < nc) {
          const float d = tu[c] - tp[c][ny - oy][nx - ox];
          const float ad = a * d;
          wsum += ad * d;
          if constexpr (GRAD) gc[c] += ad;
        }
      }
      // neighbour role: every r whose offset-o neighbour is u
      if constexpr (GRAD) {
        int cols[3];
        const int ncol = preimages(x, dx, W, cols);
        for (int i = 0; i < nr; ++i) {
          for (int j = 0; j < ncol; ++j) {
            const float ar = aff.neighbour(k, sp, rows[i], cols[j]);
#pragma unroll
            for (int c = 0; c < NMAX; ++c)
              if (c < nc) gn[c] += ar * (tp[c][rows[i] - oy][cols[j] - ox] - tu[c]);
          }
        }
      }
      ++k;
    }
  }
}

// The caller's spatial terms, window^2 floats row-major on the host, into
// dst laid out for MAX_WIN (offsets beyond the window get 0).
inline void fill_spatial(float* dst, const void* src, int pad) {
  const float* sp = static_cast<const float*>(src);
  const int win = 2 * pad + 1;
  for (int i = 0; i < MAX_WIN * MAX_WIN; ++i) dst[i] = 0.f;
  for (int dy = -pad; dy <= pad; ++dy)
    for (int dx = -pad; dx <= pad; ++dx)
      dst[(dy + MAX_PAD) * MAX_WIN + dx + MAX_PAD] = sp[(dy + pad) * win + dx + pad];
}

// Sum of `v` over the block in a fixed order (warp shuffles, then warp 0).
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (warp == 0) {
    total = lane < (blockDim.x + 31) / 32 ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
  }
  __syncthreads();
  return total;  // valid in thread 0
}

}  // namespace wsdl
