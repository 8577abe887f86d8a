// 8-connected component labelling of a batch of binary masks, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_cc.py::_cc_kernel of the JAX package
// (pallas_label_components_batch). Same result, bit for bit: each foreground
// pixel gets the linear index r*W+c of the smallest pixel of its 8-connected
// component, background gets -1. There is no round limit: the result is
// always the true fixed point, whatever the mask.
//
// Design. The TPU kernel keeps one whole label plane in VMEM and iterates a 3x3
// min plus four segmented min-scans to a fixed point. A label per pixel does
// not fit one block's shared memory here (256 KB at 256x256), but a label per
// 2x2 pixel block does: under 8-connectivity the foreground pixels of a 2x2
// block are always one component, so a block is one union-find node. Two
// plans, chosen by the wrapper from the image's shape (ops/cc.py::plan_for):
//
//   PLAN_IMAGE, one launch, one block an image, for images whose nodes fit
//   one block's shared memory (an int a node, five bit planes of 32-node
//   words and 8 KB of link buffers: 84 KB at 256x256, 67 KB at 224x224; up
//   to 432x432). A thread takes a 32-node word of a node row in phases 1-2,
//   so the links of 32 nodes are a few word operations:
//     1. the mask is read once, 16 bytes a load where W % 16 == 0, into four
//        bit planes (which of each node's 4 pixels are foreground);
//     2. runs of west-linked nodes (a left pixel here, a right pixel in the
//        node before) are the union-find's elements, each under its first
//        node, its head (a fifth plane);
//     3. each NW, N and NE link between node rows unites the two nodes'
//        heads, by shared-memory atomicMin hooking with path halving. A link
//        already implied by the west node's links and the row above's runs
//        is skipped, so a solid region costs about one union a node row. A
//        warp gathers its links and unites them 32 at a time. Every link
//        points to a head of smaller key, a hash of the position above the
//        position: random linking keeps the trees O(log nodes) deep, where
//        linking by position chains a solid region's row roots one under
//        the next;
//     4. every head is pointed at its root, and each root takes the minimum
//        of the first foreground pixels its nodes offer (a shared atomicMin
//        of the pixel index with the sign bit set, so it ranks below every
//        key). The smallest node of a component need not hold its smallest
//        pixel; only a node with a pixel in the top row whose west neighbour
//        in the run has none, or a run's head without one, can hold it, so
//        only those offer, and the label comes out in any order;
//     5-6. every head, then every other node, takes its label;
//     7. every pixel's int32 label is written once, 16 bytes a store where
//        W % 16 == 0.
//   From phase 3 on a thread takes half a word, so all 1024 threads work at
//   256x256. The parent array has an int of padding every 32 entries: the
//   lanes of a warp, at the same node of consecutive words, otherwise hit
//   one bank (32-way conflicts cost 17-34 % of the kernel on an H100 80GB
//   HBM3 at 700 W). No global atomics, no pointer chains through L2.
//
//   PLAN_TILES, three launches, for larger images: a block-based union-find.
//     1. cc_local:    one 32x32 tile per block. Each pixel starts as its own
//                     root in shared memory and unions with its W, NW, N and
//                     NE neighbours inside the tile; then every pixel writes
//                     its tile root (as a linear image index) to global memory.
//     2. cc_border:   unions across tile borders, on the global label plane.
//     3. cc_compress: every foreground pixel replaces its label by its root.
//   A union hooks the larger root under the smaller with atomicMin, so each
//   root is its component's smallest pixel.
//
// Atomics run in varying order in both plans, but the final labels do not
// vary.
//
// Bound. Bytes: one mask byte read and one int32 label written per pixel,
// 5 bytes per pixel (about 21 MB at [64,256,256], 6.3 us at 3.35 TB/s). What
// PLAN_IMAGE does about it: global memory sees exactly those bytes; the
// union-find lives in shared memory. A batch of B images keeps B SMs busy,
// and one image's time sets the call's below about 132 images: on an H100
// 80GB HBM3 at 700 W (PERF.md; scripts/probe_cc_phases.py splits it by
// phase) the union and root phases take most of it on speckle-like masks,
// and the node labels and label stores on solid ones.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/cc.py). The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // a tile is TILE x TILE pixels, one thread per pixel

// ---- union-find on a tile in shared memory (tile-local indices) ----

__device__ __forceinline__ int find_shared(volatile int* L, int x) {
  int p = L[x];
  while (p != x) {
    x = p;
    p = L[x];
  }
  return x;
}

__device__ __forceinline__ void unite_shared(volatile int* L, int a, int b) {
  while (true) {
    a = find_shared(L, a);
    b = find_shared(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // hook root b under the smaller root a; if b was hooked meanwhile, merge
    // a with b's new parent as well
    const int old = atomicMin((int*)&L[b], a);
    if (old == b) return;
    b = old;
  }
}

// ---- union-find on an image's label plane in global memory ----
// Reads go through L2 (__ldcg): other blocks update the plane while a block
// walks it, and L1 is not coherent across SMs.

__device__ __forceinline__ int find_global(const int* L, int x) {
  int p = __ldcg(L + x);
  while (p != x) {
    x = p;
    p = __ldcg(L + x);
  }
  return x;
}

__device__ __forceinline__ void unite_global(int* L, int a, int b) {
  while (true) {
    a = find_global(L, a);
    b = find_global(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(L + b, a);
    if (old == b) return;
    b = old;
  }
}

// grid (ceil(W/TILE), ceil(H/TILE), B), block (TILE, TILE)
__global__ void cc_local(const uint8_t* __restrict__ mask, int* __restrict__ labels,
                         int H, int W) {
  __shared__ int L[TILE * TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int r = r0 + ty, c = c0 + tx;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int li = ty * TILE + tx;
  const bool inside = r < H && c < W;
  const bool fg = inside && mask[img + (size_t)r * W + c] != 0;
  // tile-local row-major order agrees with the image's linear order, so the
  // smallest tile-local root is the smallest pixel of the tile component
  L[li] = fg ? li : -1;
  __syncthreads();
  if (fg) {
    volatile int* vL = L;
    if (tx > 0 && vL[li - 1] >= 0) unite_shared(L, li, li - 1);
    if (ty > 0) {
      if (tx > 0 && vL[li - TILE - 1] >= 0) unite_shared(L, li, li - TILE - 1);
      if (vL[li - TILE] >= 0) unite_shared(L, li, li - TILE);
      if (tx < TILE - 1 && vL[li - TILE + 1] >= 0) unite_shared(L, li, li - TILE + 1);
    }
  }
  __syncthreads();
  if (inside) {
    int out = -1;
    if (fg) {
      const int root = find_shared(L, li);
      out = (r0 + root / TILE) * W + c0 + root % TILE;
    }
    labels[img + (size_t)r * W + c] = out;
  }
}

// grid (ceil(W/TILE), ceil(H/TILE), B), block (TILE). Every 8-neighbour edge
// (p, q) with q the W, NW, N or NE neighbour of p that crosses a tile border
// has p in its tile's top row, left column or right column.
__global__ void cc_border(const uint8_t* __restrict__ mask, int* __restrict__ labels,
                          int H, int W) {
  const int t = threadIdx.x;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const size_t img = (size_t)blockIdx.z * H * W;
  const uint8_t* M = mask + img;
  int* L = labels + img;

  // top row: all of NW, N, NE lie in the tiles above
  if (r0 > 0) {
    const int c = c0 + t;
    if (c < W && M[r0 * W + c]) {
      const int p = r0 * W + c;
      for (int dc = -1; dc <= 1; ++dc) {
        const int cc = c + dc;
        if (cc >= 0 && cc < W && M[(r0 - 1) * W + cc]) unite_global(L, p, (r0 - 1) * W + cc);
      }
    }
  }
  const int r = r0 + t;
  if (r >= H) return;
  // left column: W, and NW below the top row, lie in the tile to the left
  if (c0 > 0 && M[r * W + c0]) {
    const int p = r * W + c0;
    if (M[r * W + c0 - 1]) unite_global(L, p, r * W + c0 - 1);
    if (t > 0 && M[(r - 1) * W + c0 - 1]) unite_global(L, p, (r - 1) * W + c0 - 1);
  }
  // right column: NE below the top row lies in the tile to the right
  const int cr = c0 + TILE - 1;
  if (t > 0 && cr + 1 < W && M[r * W + cr] && M[(r - 1) * W + cr + 1]) {
    unite_global(L, r * W + cr, (r - 1) * W + cr + 1);
  }
}

// grid (ceil(H*W/256), B), block (256)
__global__ void cc_compress(int* __restrict__ labels, int HW) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HW) return;
  int* L = labels + (size_t)blockIdx.y * HW;
  const int v = __ldcg(L + i);
  if (v >= 0) L[i] = find_global(L, v);
}

// ---- PLAN_IMAGE: one image's union-find over 2x2 nodes in shared memory ----
//
// Node (i, j) holds pixels (2i, 2j), (2i, 2j+1), (2i+1, 2j), (2i+1, 2j+1).
// Nodes are numbered row-major, R = ceil(W/2) a row, and held as bit planes:
// word w of node row i has bit k for node j = 32w + k in plane A where pixel
// (2i, 2j) is foreground, B for (2i, 2j+1), C for (2i+1, 2j), D for
// (2i+1, 2j+1) (pixels past the edge are background).

constexpr int IMAGE_THREADS = 1024;
constexpr int LINKS = 64;           // a warp's buffer of links waiting to be united
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may opt into (sm_90)
constexpr int MAX_DEVICES = 64;
constexpr int LABEL_FLAG = static_cast<int>(0x80000000u);  // marks a root's label
constexpr unsigned FULL = 0xffffffffu;

// Shared bytes of PLAN_IMAGE: five planes of words (A, B, C, D and the run
// heads), the parents (parent_ints), and each warp's link buffer.
// ops/cc.py::image_plan_bytes is the same.
__host__ __device__ __forceinline__ long long parent_ints(long long nodes) {
  return nodes + (nodes >> 5);  // an int of padding after every 32 (Parents)
}
__host__ __device__ __forceinline__ long long image_smem_bytes(int H, int W) {
  const long long rows = (H + 1) / 2, R = (W + 1) / 2;
  return 5 * 4 * rows * ((R + 31) / 32) + 4 * parent_ints(rows * R) +
         4 * LINKS * (IMAGE_THREADS / 32);
}

// 0x01 in each byte of x that is not zero, 0x00 in the others.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

// 4 pixels of a row (a byte each) -> the 2 nodes' left pixels in bits 0-1
// (left) and their right pixels in bits 0-1 (right).
__device__ __forceinline__ void split_pixels(unsigned x, unsigned& left, unsigned& right) {
  const unsigned nz = nonzero_bytes(x);
  left = (nz & 1u) | ((nz >> 15) & 2u);
  right = ((nz >> 8) & 1u) | ((nz >> 23) & 2u);
}

// The node-row words of planes X for the word before (bit k gets bit k-1) and
// after (bit k gets bit k+1) this one, with the neighbouring words' edge bits.
__device__ __forceinline__ unsigned from_left(unsigned x, unsigned before) {
  return (x << 1) | (before >> 31);
}
__device__ __forceinline__ unsigned from_right(unsigned x, unsigned after) {
  return (x >> 1) | (after << 31);
}

// A head's entry in the parent array is the key of its parent: a 15-bit hash
// of the parent's position above the position itself (16 bits; the plan's
// shared-memory limit keeps nodes below 2^16). Unions hook the root with the
// larger key under the smaller, so the forest's depth is that of random
// linking, O(log nodes), where hooking by position chains a solid region's
// row roots one under the next.
constexpr int POS_BITS = 16;
constexpr int POS_MASK = (1 << POS_BITS) - 1;

// The parent array: an entry a node, with an int of padding after every 32,
// so that the lanes of a warp, each at the same node of consecutive words,
// fall in 32 different banks instead of one.
struct Parents {
  volatile int* p;
  __device__ __forceinline__ volatile int& operator[](int n) const { return p[n + (n >> 5)]; }
};

__device__ __forceinline__ int node_key(int n) {
  return static_cast<int>((static_cast<unsigned>(n) * 0x9e3779b1u) >> 17 << POS_BITS) | n;
}

// The root of x while unions run, halving the path as it walks (every store
// points a node at one of its ancestors, a smaller key).
__device__ __forceinline__ int find_halving(const Parents& L, int x) {
  while (true) {
    const int p = L[x] & POS_MASK;
    if (p == x) return x;
    const int gk = L[p];
    const int g = gk & POS_MASK;
    if (g == p) return p;
    L[x] = gk;
    x = g;
  }
}

__device__ __forceinline__ void unite(const Parents& L, int a, int b) {
  while (true) {
    a = find_halving(L, a);
    b = find_halving(L, b);
    if (a == b) return;
    int ka = node_key(a), kb = node_key(b);
    if (ka > kb) {
      const int t = a, kt = ka;
      a = b;
      ka = kb;
      b = t;
      kb = kt;
    }
    // hook root b under a; if b was hooked meanwhile, merge a with b's new
    // parent as well
    const int old = atomicMin((int*)&L[b], ka);
    if (old == kb) return;
    b = old & POS_MASK;
  }
}

// The root of x once unions are done (a root may already hold its label, a
// negative value); reads only.
__device__ __forceinline__ int find_root(const Parents& L, int x) {
  int p = L[x];
  while (p >= 0 && (p & POS_MASK) != x) {
    x = p & POS_MASK;
    p = L[x];
  }
  return x;
}

#ifdef CC_PROBE
// Built only by scripts/probe_cc_phases.py: each block's clock at the start
// and at the end of every phase of cc_image (the barrier makes it the
// block's slowest warp).
constexpr int PROBE_BLOCKS = 256, PROBE_STAMPS = 8;
__device__ long long cc_probe[PROBE_BLOCKS * PROBE_STAMPS];
#define CC_STAMP(k)                                                                  \
  do {                                                                               \
    __syncthreads();                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < PROBE_BLOCKS)                               \
      cc_probe[blockIdx.x * PROBE_STAMPS + (k)] = clock64();                         \
  } while (0)
#else
#define CC_STAMP(k) \
  do {              \
  } while (0)
#endif

// The first node of the run of west-linked nodes that holds foreground node
// j of node row i: the nearest head at or before it (heads: the row's words
// of run heads).
__device__ __forceinline__ int head_of(const unsigned* heads, int R, int i, int j) {
  int w = j >> 5;
  unsigned x = heads[w] & (FULL >> (31 - (j & 31)));
  while (x == 0u) x = heads[--w];
  return i * R + 32 * w + 31 - __clz(x);
}

// The planes' words of one node-row word and its neighbours.
struct Word {
  unsigned a, b, c, d;          // this word
  unsigned before_bd, before_ab, before_b;  // the word before: B|D, A|B, B
  __device__ __forceinline__ Word(const unsigned* A, const unsigned* B, const unsigned* C,
                                  const unsigned* D, int t, bool first) {
    a = A[t];
    b = B[t];
    c = C[t];
    d = D[t];
    before_bd = first ? 0u : B[t - 1] | D[t - 1];
    before_ab = first ? 0u : A[t - 1] | B[t - 1];
    before_b = first ? 0u : B[t - 1];
  }
  __device__ __forceinline__ unsigned fg() const { return a | b | c | d; }
  __device__ __forceinline__ unsigned top() const { return a | b; }
  // west-linked to the node before: a left pixel here and a right pixel there
  __device__ __forceinline__ unsigned west() const { return (a | c) & from_left(b | d, before_bd); }
};

// grid (B), block (min(1024, nodes rounded up to 32)), image_smem_bytes(H, W)
// of dynamic shared memory. vec: W % 16 == 0 and both pointers 16-byte aligned.
// A thread takes a 32-node word of a node row in phases 1-2 and half a word
// after, so the links of its nodes are a few word operations.
__global__ void __launch_bounds__(IMAGE_THREADS)
cc_image(const uint8_t* __restrict__ mask, int* __restrict__ labels, int H, int W, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = (W + 1) / 2, rows = (H + 1) / 2, WPR = (R + 31) / 32, words = rows * WPR;
  const int nodes = rows * R;
  unsigned* A = reinterpret_cast<unsigned*>(smem);
  unsigned* B = A + words;
  unsigned* C = B + words;
  unsigned* D = C + words;
  unsigned* HEADS = D + words;
  const Parents L{reinterpret_cast<int*>(HEADS + words)};
  const uint8_t* M = mask + static_cast<size_t>(blockIdx.x) * H * W;
  int* out = labels + static_cast<size_t>(blockIdx.x) * H * W;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  CC_STAMP(0);

  // 1. the planes, a word a thread: 64 pixels of each of two rows
  for (int t = tid; t < words; t += nthreads) {
    const int i = t / WPR, w = t - i * WPR;
    unsigned left[2] = {0u, 0u}, right[2] = {0u, 0u};  // pixel rows 2i, 2i+1
    if (vec) {
      uint4 px[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = 64 * w + 16 * k;
          px[h][k] = make_uint4(0, 0, 0, 0);
          if (2 * i + h < H && col < W)
            px[h][k] = __ldg(reinterpret_cast<const uint4*>(
                M + static_cast<size_t>(2 * i + h) * W + col));
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned v[4] = {px[h][k].x, px[h][k].y, px[h][k].z, px[h][k].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            unsigned l, r;
            split_pixels(v[e], l, r);
            left[h] |= l << (8 * k + 2 * e);
            right[h] |= r << (8 * k + 2 * e);
          }
        }
    } else {
      for (int k = 0; k < 32; ++k) {
        const int c = 2 * (32 * w + k);
        if (c >= W) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * i + h >= H) continue;
          const uint8_t* row = M + static_cast<size_t>(2 * i + h) * W;
          left[h] |= static_cast<unsigned>(row[c] != 0) << k;
          if (c + 1 < W) right[h] |= static_cast<unsigned>(row[c + 1] != 0) << k;
        }
      }
    }
    A[t] = left[0];
    B[t] = right[0];
    C[t] = left[1];
    D[t] = right[1];
  }
  __syncthreads();
  CC_STAMP(1);

  // 2. the run heads (foreground nodes not west-linked; a run continues
  // across words), and each head's entry: its own key
  for (int t = tid; t < words; t += nthreads) {
    const int i = t / WPR, w = t - i * WPR;
    const Word x(A, B, C, D, t, w == 0);
    const unsigned heads = x.fg() & ~x.west();
    HEADS[t] = heads;
    for (unsigned m = heads; m; m &= m - 1u) {
      const int n = i * R + 32 * w + __ffs(m) - 1;
      L[n] = node_key(n);
    }
  }
  __syncthreads();
  CC_STAMP(2);

  // 3. unions of the runs through the NW, N and NE links. A link to a node
  // of the row above is skipped where that node is already joined to this
  // one: through the west node's N or NE link, or through this node's link
  // to the above node's west neighbour in the same run. Each link unites the
  // two nodes' run heads. A warp gathers its links (two heads, 16 bits each)
  // in its buffer, a link a lane at a time, and unites them 32 at a time
  // from one call, so no lane waits on another's unions.
  {
    const int warp = tid / 32, lane = tid % 32;
    const unsigned below = (1u << lane) - 1u;
    int* links = reinterpret_cast<int*>(HEADS + words) + parent_ints(nodes) + warp * LINKS;
    int pending = 0;  // links in the warp's buffer, the same in every lane
    // every half word in turn; the same trips in every lane (ballots)
    for (int item0 = tid - lane; item0 < 2 * words; item0 += nthreads) {
      const int item = item0 + lane, t = item >> 1, i = t / WPR, w = t - i * WPR;
      unsigned need_nw = 0u, need_n = 0u, need_ne = 0u;
      if (item < 2 * words && i > 0) {
        const Word x(A, B, C, D, t, w == 0);
        const int u = t - WPR;  // the word above
        const unsigned ua = A[u], ub = B[u], uc = C[u], ud = D[u];
        const unsigned pb = w > 0 ? B[u - 1] : 0u, pc = w > 0 ? C[u - 1] : 0u;
        const unsigned pd = w > 0 ? D[u - 1] : 0u;
        const unsigned na = w + 1 < WPR ? A[u + 1] : 0u, nc = w + 1 < WPR ? C[u + 1] : 0u;
        const unsigned west = x.west();
        // the above node's west neighbour (aw) and east neighbour (ae), by pixel
        const unsigned aw_cd = from_left(uc | ud, pc | pd), aw_d = from_left(ud, pd);
        const unsigned aw_bd = from_left(ub | ud, pb | pd);
        const unsigned ae_ac = from_right(ua | uc, na | nc), ae_c = from_right(uc, nc);
        const unsigned q_ab = from_left(x.top(), x.before_ab), q_b = from_left(x.b, x.before_b);
        // joined: the above node is in this node's set already
        unsigned joined_w = west & q_ab & aw_cd;
        const unsigned nw = x.a & aw_d;
        need_nw = nw & ~joined_w;
        joined_w |= nw;
        unsigned joined = (west & q_b & uc) | (joined_w & (ua | uc) & aw_bd);
        const unsigned n = x.top() & (uc | ud);
        need_n = n & ~joined;
        joined |= n;
        need_ne = x.b & ae_c & ~(joined & ae_ac & (ub | ud));
        const unsigned half = (item & 1) ? 0xffff0000u : 0x0000ffffu;
        need_nw &= half;
        need_n &= half;
        need_ne &= half;
      }
      while (__any_sync(FULL, (need_nw | need_n | need_ne) != 0u)) {
        const bool has_link = (need_nw | need_n | need_ne) != 0u;
        int link = 0;  // two 16-bit heads: may be negative as an int
        if (has_link) {
          // this lane's next link: its lowest node, NW before N before NE
          const unsigned m = need_nw | need_n | need_ne, bit = m & (0u - m);
          const int j = 32 * w + __ffs(m) - 1;
          const int dj = (need_nw & bit) ? -1 : (need_n & bit) ? 0 : 1;
          if (dj < 0) need_nw &= ~bit; else if (dj == 0) need_n &= ~bit; else need_ne &= ~bit;
          const unsigned* heads = HEADS + i * WPR;
          link = static_cast<int>((static_cast<unsigned>(head_of(heads, R, i, j)) << POS_BITS) |
                                  head_of(heads - WPR, R, i - 1, j + dj));
        }
        const unsigned has = __ballot_sync(FULL, has_link);
        if (has_link) links[pending + __popc(has & below)] = link;
        pending += __popc(has);
        __syncwarp();
        if (pending >= 32) {
          const int e = links[pending - 32 + lane];
          __syncwarp();  // read before the next links overwrite it
          unite(L, static_cast<int>(static_cast<unsigned>(e) >> POS_BITS), e & POS_MASK);
          pending -= 32;
        }
      }
    }
    if (lane < pending) {
      const int e = links[lane];
      unite(L, static_cast<int>(static_cast<unsigned>(e) >> POS_BITS), e & POS_MASK);
    }
  }
  __syncthreads();
  CC_STAMP(3);

  // 4. every head points at its root; each root takes the smallest first
  // foreground pixel of its nodes. Only a node that may hold its component's
  // smallest pixel offers its first pixel: a node with a pixel in the top row
  // whose west neighbour in the run has none, or a run's head without one.
  // A thread takes half a word. Walks only read; a head's entry is written
  // by its own thread alone, a root's only by the offers' atomicMin.
  for (int item = tid; item < 2 * words; item += nthreads) {
    const int t = item >> 1, i = t / WPR, w = t - i * WPR;
    const unsigned half = (item & 1) ? 0xffff0000u : 0x0000ffffu;
    const Word x(A, B, C, D, t, w == 0);
    const unsigned heads = HEADS[t];
    for (unsigned m = heads & half; m; m &= m - 1u) {
      const int h = i * R + 32 * w + __ffs(m) - 1;
      const int root = find_root(L, h);
      if (root != h) L[h] = node_key(root);
    }
    const unsigned top = x.top();
    const unsigned offers = (top & ~(x.west() & from_left(top, x.before_ab))) | (heads & ~top);
    for (unsigned m = offers & half; m; m &= m - 1u) {
      const int k = __ffs(m) - 1, j = 32 * w + k;
      const unsigned bit = 1u << k;
      const bool in_top = top & bit;
      const bool left = (in_top ? x.a : x.c) & bit;
      const int first = (2 * i + (in_top ? 0 : 1)) * W + 2 * j + (left ? 0 : 1);
      const int root = find_root(L, head_of(HEADS + i * WPR, R, i, j));
      atomicMin((int*)&L[root], first | LABEL_FLAG);
    }
  }
  __syncthreads();
  CC_STAMP(4);

  // 5. every head takes its root's label
  for (int item = tid; item < 2 * words; item += nthreads) {
    const int t = item >> 1, i = t / WPR, w = t - i * WPR;
    const unsigned half = (item & 1) ? 0xffff0000u : 0x0000ffffu;
    for (unsigned m = HEADS[t] & half; m; m &= m - 1u) {
      const int h = i * R + 32 * w + __ffs(m) - 1;
      const int v = L[h];
      if (v >= 0) L[h] = L[v & POS_MASK];
    }
  }
  __syncthreads();
  CC_STAMP(5);

  // 6. every other foreground node takes its run head's (only heads' entries
  // are read here, and only other nodes' written)
  for (int item = tid; item < 2 * words; item += nthreads) {
    const int t = item >> 1, i = t / WPR, w = t - i * WPR;
    const unsigned half = (item & 1) ? 0xffff0000u : 0x0000ffffu;
    const unsigned heads = HEADS[t], members = (A[t] | B[t] | C[t] | D[t]) & ~heads & half;
    if (members == 0u) continue;
    const int base = i * R + 32 * w;
    int head = -1, label = 0;
    for (unsigned m = members; m; m &= m - 1u) {
      const int k = __ffs(m) - 1;
      const unsigned upto = heads & (FULL >> (31 - k));
      // the run's head: this word's last head before k, else in a word before
      const int h = upto ? base + 31 - __clz(upto) : head_of(HEADS + i * WPR, R, i, 32 * w + k);
      if (h != head) {
        head = h;
        label = L[h];
      }
      L[base + k] = label;
    }
  }
  __syncthreads();
  CC_STAMP(6);

  // 7. the labels
  if (vec) {
    const int quads = W / 4;
    int r = tid / quads, c = 4 * (tid % quads);
    const int dr = nthreads / quads, dc = 4 * (nthreads % quads);
    for (; r < H; r += dr, c += dc) {
      if (c >= W) {
        c -= W;
        ++r;
        if (r >= H) break;
      }
      const int i = r >> 1, j = c >> 1, t = i * WPR + (j >> 5), k = j & 31;
      const unsigned lw = (r & 1) ? C[t] : A[t], rw = (r & 1) ? D[t] : B[t];
      const unsigned bits = ((lw >> k) & 3u) | (((rw >> k) & 3u) << 2);  // l0 l1 r0 r1
      const int n = i * R + j;
      const int l0 = (bits & 5u) ? L[n] & 0x7fffffff : -1;
      const int l1 = (bits & 10u) ? L[n + 1] & 0x7fffffff : -1;
      const int4 o = make_int4((bits & 1u) ? l0 : -1, (bits & 4u) ? l0 : -1,
                               (bits & 2u) ? l1 : -1, (bits & 8u) ? l1 : -1);
      *reinterpret_cast<int4*>(out + static_cast<size_t>(r) * W + c) = o;
    }
  } else {
    for (int e = tid; e < H * W; e += nthreads) {
      const int r = e / W, c = e - r * W, i = r >> 1, j = c >> 1;
      const int t = i * WPR + (j >> 5), k = j & 31;
      const unsigned* plane = (r & 1) ? ((c & 1) ? D : C) : ((c & 1) ? B : A);
      out[e] = (plane[t] >> k) & 1u ? L[i * R + j] & 0x7fffffff : -1;
    }
  }
  CC_STAMP(7);
}

enum Plan { PLAN_IMAGE = 0, PLAN_TILES = 1 };

}  // namespace

#ifdef CC_PROBE
// The probe's clocks, PROBE_BLOCKS x PROBE_STAMPS int64, into host memory.
extern "C" int wsdl_cc_probe(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, cc_probe, sizeof(cc_probe)));
}
#endif

// mask: uint8 [B,H,W] (nonzero = foreground), labels: int32 [B,H,W], both
// contiguous on the device; plan: PLAN_IMAGE (the image's nodes must fit
// SMEM_LIMIT) or PLAN_TILES; stream: the cudaStream_t to launch on.
// Requires B <= 65535 and B*H*W < 2^31 (the wrapper checks).
extern "C" int wsdl_cc_label(const void* mask, void* labels, int B, int H, int W, int plan,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* l = static_cast<int*>(labels);
  if (plan == PLAN_IMAGE) {
    const long long smem = image_smem_bytes(H, W);
    if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    // the opt-in above 48 KB, raised to the limit once a device (it costs
    // host time on every call otherwise)
    static bool raised[MAX_DEVICES] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= MAX_DEVICES || !raised[device]) {
      err = cudaFuncSetAttribute(cc_image, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (device < MAX_DEVICES) raised[device] = true;
    }
    const long long nodes = static_cast<long long>((H + 1) / 2) * ((W + 1) / 2);
    const int threads = static_cast<int>(nodes >= IMAGE_THREADS ? IMAGE_THREADS
                                                                : (nodes + 31) / 32 * 32);
    const int vec = W % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(labels) % 16 == 0;
    cc_image<<<B, threads, static_cast<size_t>(smem), s>>>(m, l, H, W, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (plan != PLAN_TILES) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 tiles((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  cc_local<<<tiles, dim3(TILE, TILE), 0, s>>>(m, l, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_border<<<tiles, TILE, 0, s>>>(m, l, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HW = H * W;
  cc_compress<<<dim3((HW + 255) / 256, B), 256, 0, s>>>(l, HW);
  return static_cast<int>(cudaGetLastError());
}
