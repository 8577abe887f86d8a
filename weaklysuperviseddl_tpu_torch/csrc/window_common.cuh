// Pieces shared by the window-affinity kernels (window.cu) and the refinement
// kernel (refine.cu): the tile geometry, reflect indexing and its preimages,
// the colour affinity of one pixel pair, one pixel's window sum and gradient
// (window_terms; centre_terms and a table of one affinity per pixel pair,
// fill_pairs, for the faster paths of the refinement and of both window.cu
// kernels), and a fixed-order block sum.
//
// The window term of pixel r and offset o pairs r with its neighbour
// n = reflect(r + o) (jnp.pad(mode="reflect"): the edge is not repeated):
//     aff_o(r) = exp(-|I(r) - I(n)|^2 / (2 sc^2) - spatial_o)
// Every kernel computes it with affinity() below, whose products and sums are
// rounded one at a time (no fused multiply-add), so a kernel that reads stored
// affinities gets the same bits as one that recomputes them. The colour
// difference enters squared and the spatial term |o|^2 / (2 ss^2) is the same
// for o and -o, so over a halo that holds reflect's values (shared position z
// holds image pixel reflect(z)) the affinity of positions p and p + o is that
// of p + o and p: one value per pair of positions.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace wsdl {

constexpr int TILE = 16;                   // a tile is TILE x TILE pixels
constexpr int THREADS = TILE * TILE;       // one thread per tile pixel
constexpr int MAX_PAD = 3;                 // windows up to 7x7
constexpr int MAX_WIN = 2 * MAX_PAD + 1;
constexpr int HALO = TILE + 2 * MAX_PAD;

template <int PAD>
struct Window {
  static constexpr int WIN = 2 * PAD + 1;
  static constexpr int K = WIN * WIN - 1;   // offsets, the centre left out
  static constexpr int HALF = K / 2;        // offsets before (and after) the centre
  // the index of offset (dy, dx) in row-major order without the centre
  __host__ __device__ static constexpr int index(int dy, int dx) {
    return (dy + PAD) * WIN + dx + PAD - ((dy + PAD) * WIN + dx + PAD > HALF ? 1 : 0);
  }
  // fill_pairs' table: for each of the HALF offsets after the centre, rows
  // [-PAD, TILE) and columns [-PAD, TILE + PAD) around the tile
  static constexpr int PAIR_ROWS = TILE + PAD, PAIR_COLS = TILE + 2 * PAD;
  static constexpr int PAIRS = HALF * PAIR_ROWS * PAIR_COLS;
};

__device__ __forceinline__ int reflect(int z, int n) {
  return z < 0 ? -z : (z >= n ? 2 * (n - 1) - z : z);
}

// The image coordinate a halo position z holds: reflect(z, n), or -1 past
// the reflect's reach (no pixel of the image reads such a position).
__device__ __forceinline__ int reflect_reach(int z, int n) {
  return z < -(n - 1) || z > 2 * (n - 1) ? -1 : reflect(z, n);
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

__device__ __forceinline__ float spatial_of(const float* spatial, int dy, int dx) {
  return spatial[(dy + MAX_PAD) * MAX_WIN + dx + MAX_PAD];
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

// True if pixel (y, x) lies within pad of an image edge. Only there does
// reflect add a preimage. Everywhere else u has exactly one preimage per
// offset, u - o, whose term is aff_{-o}(u) (t(u - o) - t(u)): the neighbour
// role's sum is minus the centre role's, so d wsum / d t(u) is
// 4 sum_o aff_o(u) d_o(u).
__device__ __forceinline__ bool near_edge(int y, int x, int H, int W, int pad) {
  return min(min(y, H - 1 - y), min(x, W - 1 - x)) <= pad;
}

// True if no pixel of the tile at (ty0, tx0) is near_edge (and the tile lies
// inside the image).
__device__ __forceinline__ bool interior_tile(int ty0, int tx0, int H, int W, int pad) {
  return ty0 >= pad + 1 && tx0 >= pad + 1 && ty0 + TILE + pad + 1 <= H &&
         tx0 + TILE + pad + 1 <= W;
}

// One affinity per pair of positions that touches a tile: s_pair[h][ry][rx]
// = the affinity of positions p and p + o, for o the h-th offset after the
// centre and p = (ty0 + ry - PAD, tx0 + rx - PAD), written where p or p + o
// lies in the tile (the rest of the table is not read). s_img holds the tile
// and its halo of PAD pixels with reflect's values (shared coordinates =
// image coordinates - (ty0 - PAD, tx0 - PAD)), so for p in the image this is
// aff_o(p) of window_terms, bit for bit; spatial as in window_terms. Each
// thread takes a position and computes its HALF offsets.
template <int PAD>
__device__ __forceinline__ void fill_pairs(const float (*s_img)[HALO][HALO], float* s_pair,
                                           const float* spatial, float inv2sc) {
  using Wn = Window<PAD>;
  constexpr int ROWS = Wn::PAIR_ROWS, COLS = Wn::PAIR_COLS;
  for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
    const int ry = i / COLS, rx = i % COLS;
    const int py = ry - PAD, px = rx - PAD;  // p relative to the tile's origin
    const bool p_in = py >= 0 && px >= 0 && px < TILE;
    const float i0 = s_img[0][ry][rx], i1 = s_img[1][ry][rx], i2 = s_img[2][ry][rx];
#pragma unroll
    for (int h = 0; h < Wn::HALF; ++h) {
      const int m = Wn::HALF + 1 + h;  // row-major index with the centre
      const int dy = m / Wn::WIN - PAD, dx = m % Wn::WIN - PAD;
      const int ny = py + dy, nx = px + dx;
      if (p_in || (ny >= 0 && ny < TILE && nx >= 0 && nx < TILE)) {
        const int sy = ry + dy, sx = rx + dx;
        s_pair[(h * ROWS + ry) * COLS + rx] =
            affinity(i0 - s_img[0][sy][sx], i1 - s_img[1][sy][sx], i2 - s_img[2][sy][sx], inv2sc,
                     spatial_of(spatial, dy, dx));
      }
    }
  }
}

// fill_pairs' table read by tile pixel u at (uy, ux) from the tile's origin:
// aff_o(u) for o after the centre, the pair (u + o, u) for o before it (the
// same pair, the same bits).
template <int PAD>
struct PairAffinity {
  const float* s_pair;
  int uy, ux;
  __device__ __forceinline__ float pair(int k, int dy, int dx) const {
    using Wn = Window<PAD>;
    constexpr int ROWS = Wn::PAIR_ROWS, COLS = Wn::PAIR_COLS;
    if (k >= Wn::HALF)
      return s_pair[((k - Wn::HALF) * ROWS + uy + PAD) * COLS + ux + PAD];
    return s_pair[((Wn::K - 1 - k - Wn::HALF) * ROWS + uy + dy + PAD) * COLS + ux + dx + PAD];
  }
};

// The window terms of tile pixel u = (y, x), for the classes c < nc (nc <=
// NMAX) of tp, t over the tile and its halo in shared memory (shared
// coordinates = image coordinates - (oy, ox)), over the window's rows
// dy_lo..dy_hi:
//   wsum  += sum_o sum_c aff_o(u) d_o,c(u)^2,   d_o,c(r) = t_c(r) - t_c(reflect(r + o))
//   gc[c] += sum_o aff_o(u) d_o,c(u)                                  (GRAD)
//   gn[c] += sum_o sum_{r: reflect(r+o)=u} aff_o(r) d_o,c(r)           (GRAD)
// so d wsum / d t_c(u) = 2 (gc[c] - gn[c]) over the whole window (rows -pad
// to pad): the gather form of the transpose of the reflect fold, one write
// per pixel, no scatters. Offsets run row-major without the centre (k counts
// them), so every kernel of the window family that takes the whole window
// sums in one order; `spatial` is laid out for MAX_WIN. aff gives the
// affinities (TileAffinity, or stored planes). The window stays a runtime loop here: unrolled over a
// compile-time window this path took 80-182 registers instead of 63-64, and
// window.cu's backward ran 2.5x slower on an H100.
template <int NMAX, bool GRAD, class Aff>
__device__ __forceinline__ void window_terms(const float (*tp)[HALO][HALO], int nc, int y, int x,
                                             int H, int W, int pad, int oy, int ox,
                                             const float* spatial, const Aff& aff, int dy_lo,
                                             int dy_hi, float& wsum, float* gc, float* gn) {
  float tu[NMAX];
#pragma unroll
  for (int c = 0; c < NMAX; ++c) tu[c] = c < nc ? tp[c][y - oy][x - ox] : 0.f;
  int k = (dy_lo + pad) * (2 * pad + 1) - (dy_lo > 0 ? 1 : 0);
#pragma unroll 1
  for (int dy = dy_lo; dy <= dy_hi; ++dy) {
    const int ny = reflect(y + dy, H);
    int rows[3];
    int nr = 0;
    if constexpr (GRAD) nr = preimages(y, dy, H, rows);
#pragma unroll 1
    for (int dx = -pad; dx <= pad; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float sp = spatial_of(spatial, dy, dx);
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

// The centre role of window_terms for tile pixel u at shared coordinates
// (sy, sx) of tp, over a halo that holds reflect's values: the same wsum, in
// the same order and with the same bits, and gc[c] += sum_o aff_o(u)
// d_o,c(u). Away from the edges (near_edge false) the gradient is 4 gc[c].
// The window unrolls; aff.pair(k, dy, dx) gives aff_o(u) (PairAffinity, or
// stored planes).
template <int PAD, int NMAX, bool GRAD, class Aff>
__device__ __forceinline__ void centre_terms(const float (*tp)[HALO][HALO], int nc, int sy,
                                             int sx, const Aff& aff, float& wsum, float* gc) {
  float tu[NMAX];
#pragma unroll
  for (int c = 0; c < NMAX; ++c) tu[c] = c < nc ? tp[c][sy][sx] : 0.f;
#pragma unroll
  for (int dy = -PAD; dy <= PAD; ++dy) {
#pragma unroll
    for (int dx = -PAD; dx <= PAD; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float a = aff.pair(Window<PAD>::index(dy, dx), dy, dx);
#pragma unroll
      for (int c = 0; c < NMAX; ++c) {
        if (c < nc) {
          const float d = tu[c] - tp[c][sy + dy][sx + dx];
          const float ad = a * d;
          wsum += ad * d;
          if constexpr (GRAD) gc[c] += ad;
        }
      }
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
