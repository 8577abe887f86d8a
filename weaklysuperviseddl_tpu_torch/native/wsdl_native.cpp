// wsdl_native — the port's host-side goldens (a copy of the JAX package's
// native/wsdl_native.cpp, built on its own by native/__init__.py).
//
// The reference offloads its two native compute dependencies to third-party
// C extensions: pydensecrf (Krähenbühl's permutohedral mean-field DenseCRF;
// TraditionalModel/AlternatingDirectionCutLoss.py:183-204) and skimage's
// union-find connected components (PsuedoMasks.py:15-21). The tests and
// chip_smoke.py's `goldens` phase hold the port's CRF backends and its
// connected-component kernel against these independent host versions:
//
//   * dense-CRF mean field with Gaussian + bilateral pairwise kernels,
//     - exact O(N²) path (test-scale golden: the mathematical definition)
//     - permutohedral-lattice path (Adams et al. 2010)
//     Semantics (the port's CRF uses the same): symmetric kernel
//     normalization k'(x,y)=k(x,y)/√(n(x)n(y)) with n = k⊗1, self-INCLUDED
//     messages m = K'Q (scale-invariant, so the lattice's constant-scale
//     approximation cancels), Potts update Q ← softmax(−U + Σ_k w_k m_k).
//   * 8-connectivity union-find connected-component labeling +
//     largest-component filter.
//
// C ABI for ctypes; no Python headers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Permutohedral lattice (d-dimensional high-dimensional Gaussian filter)
// ---------------------------------------------------------------------------
class Permutohedral {
 public:
  // flat open-addressing hash table over short[d] keys (a std::unordered_map
  // of vector<short> keys measured ~4× slower on lattice construction)
  struct FlatTable {
    int d = 0;
    size_t mask = 0;
    std::vector<int> slots;       // lattice index or -1
    std::vector<short>* keys = nullptr;  // flat key storage, d shorts per entry

    void init(int dd, size_t expected, std::vector<short>* key_store) {
      d = dd;
      keys = key_store;
      size_t cap = 16;
      while (cap < expected * 2) cap <<= 1;
      mask = cap - 1;
      slots.assign(cap, -1);
    }
    static size_t hash_key(const short* k, int d) {
      size_t h = 0x9e3779b97f4a7c15ull;
      for (int i = 0; i < d; i++) {
        h ^= (size_t)(unsigned short)k[i];
        h *= 0x100000001b3ull;
      }
      return h;
    }
    bool equal(int idx, const short* k) const {
      const short* stored = keys->data() + (size_t)idx * d;
      for (int i = 0; i < d; i++)
        if (stored[i] != k[i]) return false;
      return true;
    }
    // find existing or insert (returns lattice index)
    int find_or_insert(const short* k) {
      size_t h = hash_key(k, d) & mask;
      while (true) {
        int s = slots[h];
        if (s == -1) {
          int idx = (int)(keys->size() / d);
          keys->insert(keys->end(), k, k + d);
          slots[h] = idx;
          return idx;
        }
        if (equal(s, k)) return s;
        h = (h + 1) & mask;
      }
    }
    int find(const short* k) const {
      size_t h = hash_key(k, d) & mask;
      while (true) {
        int s = slots[h];
        if (s == -1) return -1;
        if (equal(s, k)) return s;
        h = (h + 1) & mask;
      }
    }
  };

  void init(const float* positions, int N, int d) {
    N_ = N;
    d_ = d;
    offsets_.assign((size_t)N * (d + 1), 0);
    weights_.assign((size_t)N * (d + 1), 0.f);

    std::vector<float> scale(d);
    const float inv_std_dev = std::sqrt(2.0f / 3.0f) * (d + 1);
    for (int i = 0; i < d; i++)
      scale[i] = 1.0f / std::sqrt((float)((i + 2) * (i + 1))) * inv_std_dev;

    std::vector<float> elevated(d + 1), barycentric(d + 2);
    std::vector<int> rem0(d + 1), rank(d + 1);
    std::vector<short> key(d);

    FlatTable table;
    // worst case one new lattice vertex per (point, simplex corner)
    table.init(d, (size_t)N * (d + 1), &keys_);

    for (int n = 0; n < N; n++) {
      const float* p = positions + (size_t)n * d;

      // embed into the hyperplane H_d
      float sm = 0.f;
      for (int j = d; j > 0; j--) {
        float cf = p[j - 1] * scale[j - 1];
        elevated[j] = sm - j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // nearest zero-colored lattice point
      int sum = 0;
      for (int i = 0; i <= d; i++) {
        float v = elevated[i] * (1.0f / (d + 1));
        int up = (int)std::ceil(v) * (d + 1);
        int down = (int)std::floor(v) * (d + 1);
        rem0[i] = (up - elevated[i] < elevated[i] - down) ? up : down;
        sum += rem0[i];
      }
      sum /= d + 1;

      // rank differential
      std::fill(rank.begin(), rank.end(), 0);
      for (int i = 0; i < d; i++) {
        double di = elevated[i] - rem0[i];
        for (int j = i + 1; j <= d; j++) {
          if (di < elevated[j] - rem0[j]) rank[i]++;
          else rank[j]++;
        }
      }

      // wrap into canonical range
      for (int i = 0; i <= d; i++) {
        rank[i] += sum;
        if (rank[i] < 0) { rank[i] += d + 1; rem0[i] += d + 1; }
        else if (rank[i] > d) { rank[i] -= d + 1; rem0[i] -= d + 1; }
      }

      // barycentric coordinates
      std::fill(barycentric.begin(), barycentric.end(), 0.f);
      for (int i = 0; i <= d; i++) {
        float v = (elevated[i] - rem0[i]) * (1.0f / (d + 1));
        barycentric[d - rank[i]] += v;
        barycentric[d + 1 - rank[i]] -= v;
      }
      barycentric[0] += 1.0f + barycentric[d + 1];

      // splat targets: the d+1 vertices of the enclosing simplex
      for (int r = 0; r <= d; r++) {
        for (int i = 0; i < d; i++) {
          short ci = (short)(rank[i] <= d - r ? rem0[i] + r : rem0[i] + r - (d + 1));
          key[i] = ci;
        }
        int idx = table.find_or_insert(key.data());
        offsets_[(size_t)n * (d + 1) + r] = idx;
        weights_[(size_t)n * (d + 1) + r] = barycentric[r];
      }
    }
    M_ = (int)keys_.size() / d;

    // precompute blur neighbors for each lattice point and axis
    blur_n1_.assign((size_t)M_ * (d + 1), -1);
    blur_n2_.assign((size_t)M_ * (d + 1), -1);
    std::vector<short> np(d), nm(d);
    for (int j = 0; j <= d; j++) {
      for (int i = 0; i < M_; i++) {
        const short* k = keys_.data() + (size_t)i * d;
        for (int a = 0; a < d; a++) {
          np[a] = (short)(k[a] + 1);
          nm[a] = (short)(k[a] - 1);
        }
        if (j < d) {
          np[j] = (short)(k[j] - d);
          nm[j] = (short)(k[j] + d);
        }
        blur_n1_[(size_t)j * M_ + i] = table.find(np.data());
        blur_n2_[(size_t)j * M_ + i] = table.find(nm.data());
      }
    }
  }

  // filter `in` [N, C] -> `out` [N, C]
  void compute(const float* in, float* out, int C) const {
    std::vector<float> values((size_t)(M_ + 1) * C, 0.f);   // +1 zero slot
    std::vector<float> newvals((size_t)(M_ + 1) * C, 0.f);
    float* vals = values.data() + C;  // index -1 -> zeros before this

    // splat
    for (int n = 0; n < N_; n++) {
      for (int r = 0; r <= d_; r++) {
        int o = offsets_[(size_t)n * (d_ + 1) + r];
        float w = weights_[(size_t)n * (d_ + 1) + r];
        for (int c = 0; c < C; c++) vals[(size_t)o * C + c] += w * in[(size_t)n * C + c];
      }
    }

    // blur along each lattice direction with [1,2,1]
    float* cur = vals;
    float* nxt = newvals.data() + C;
    for (int j = 0; j <= d_; j++) {
      for (int i = 0; i < M_; i++) {
        int n1 = blur_n1_[(size_t)j * M_ + i];
        int n2 = blur_n2_[(size_t)j * M_ + i];
        const float* v1 = n1 >= 0 ? cur + (size_t)n1 * C : cur - C;  // -C = zero slot
        const float* v2 = n2 >= 0 ? cur + (size_t)n2 * C : cur - C;
        for (int c = 0; c < C; c++)
          nxt[(size_t)i * C + c] =
              cur[(size_t)i * C + c] * 2.f + (n1 >= 0 ? v1[c] : 0.f) + (n2 >= 0 ? v2[c] : 0.f);
      }
      std::swap(cur, nxt);
    }

    // slice with the variance-compensation factor
    const float alpha = 1.0f / (1.0f + std::pow(2.0f, -(float)d_));
    for (int n = 0; n < N_; n++) {
      for (int c = 0; c < C; c++) out[(size_t)n * C + c] = 0.f;
      for (int r = 0; r <= d_; r++) {
        int o = offsets_[(size_t)n * (d_ + 1) + r];
        float w = weights_[(size_t)n * (d_ + 1) + r];
        for (int c = 0; c < C; c++)
          out[(size_t)n * C + c] += w * cur[(size_t)o * C + c] * alpha;
      }
    }
  }

 private:
  int N_ = 0, d_ = 0, M_ = 0;
  std::vector<int> offsets_;
  std::vector<float> weights_;
  std::vector<short> keys_;
  std::vector<int> blur_n1_, blur_n2_;
};

// ---------------------------------------------------------------------------
// Mean-field with symmetric-normalized, self-excluded messages
// ---------------------------------------------------------------------------
struct Kernel {
  virtual ~Kernel() = default;
  virtual void filter(const float* in, float* out, int C) const = 0;
  int N = 0;
  std::vector<float> norm;       // raw ones-filter n(x)
  std::vector<float> inv_sqrt;   // 1/sqrt(n)

  void finalize_norm() {
    inv_sqrt.resize(N);
    for (int i = 0; i < N; i++) {
      float n = std::max(norm[i], 1e-20f);
      norm[i] = n;
      inv_sqrt[i] = 1.0f / std::sqrt(n);
    }
  }

  // m = K'Q with K' symmetric-normalized (self term included: this makes the
  // update scale-invariant, so the permutohedral filter's constant-scale
  // approximation cancels exactly and all three paths — brute force,
  // lattice, JAX bilateral-grid — share identical semantics)
  void message(const float* Q, float* out, int C, std::vector<float>& tmp) const {
    tmp.resize((size_t)N * C);
    for (int i = 0; i < N; i++)
      for (int c = 0; c < C; c++) tmp[(size_t)i * C + c] = Q[(size_t)i * C + c] * inv_sqrt[i];
    filter(tmp.data(), out, C);
    for (int i = 0; i < N; i++)
      for (int c = 0; c < C; c++) out[(size_t)i * C + c] *= inv_sqrt[i];
  }
};

struct LatticeKernel : Kernel {
  Permutohedral lattice;
  void init(const float* feats, int n, int d) {
    N = n;
    lattice.init(feats, n, d);
    std::vector<float> ones((size_t)n, 1.f);
    norm.resize(n);
    lattice.compute(ones.data(), norm.data(), 1);
  }
  void filter(const float* in, float* out, int C) const override {
    lattice.compute(in, out, C);
  }
};

struct BruteKernel : Kernel {
  std::vector<float> feats;
  int d = 0;
  void init(const float* f, int n, int dd) {
    N = n;
    d = dd;
    feats.assign(f, f + (size_t)n * dd);
    norm.assign(n, 0.f);
    for (int i = 0; i < N; i++)
      for (int j = 0; j < N; j++) norm[i] += w(i, j);
  }
  float w(int i, int j) const {
    float s = 0.f;
    for (int a = 0; a < d; a++) {
      float diff = feats[(size_t)i * d + a] - feats[(size_t)j * d + a];
      s += diff * diff;
    }
    return std::exp(-0.5f * s);
  }
  void filter(const float* in, float* out, int C) const override {
    for (int i = 0; i < N; i++) {
      for (int c = 0; c < C; c++) out[(size_t)i * C + c] = 0.f;
      for (int j = 0; j < N; j++) {
        float wij = w(i, j);
        for (int c = 0; c < C; c++) out[(size_t)i * C + c] += wij * in[(size_t)j * C + c];
      }
    }
  }
};

void build_features(int H, int W, const unsigned char* rgb, float sxy, float srgb,
                    bool bilateral, std::vector<float>& feats, int& d) {
  d = bilateral ? 5 : 2;
  feats.resize((size_t)H * W * d);
  for (int y = 0; y < H; y++) {
    for (int x = 0; x < W; x++) {
      size_t i = (size_t)y * W + x;
      float* f = feats.data() + i * d;
      f[0] = x / sxy;
      f[1] = y / sxy;
      if (bilateral) {
        f[2] = rgb[i * 3 + 0] / srgb;
        f[3] = rgb[i * 3 + 1] / srgb;
        f[4] = rgb[i * 3 + 2] / srgb;
      }
    }
  }
}

void mean_field(int H, int W, int L, const float* unary, const unsigned char* rgb,
                float gs_sxy, float gs_w, float bl_sxy, float bl_srgb, float bl_w,
                int iters, float* q_out, bool exact) {
  const int N = H * W;
  std::vector<float> feats;
  int d;

  std::vector<Kernel*> kernels;
  std::vector<float> kernel_w;

  auto make = [&](bool bilateral, float sxy, float srgb, float weight) {
    if (weight == 0.f) return;
    build_features(H, W, rgb, sxy, srgb, bilateral, feats, d);
    Kernel* k;
    if (exact) {
      auto* b = new BruteKernel();
      b->init(feats.data(), N, d);
      k = b;
    } else {
      auto* l = new LatticeKernel();
      l->init(feats.data(), N, d);
      k = l;
    }
    k->finalize_norm();
    kernels.push_back(k);
    kernel_w.push_back(weight);
  };
  make(false, gs_sxy, 0.f, gs_w);
  make(true, bl_sxy, bl_srgb, bl_w);

  // Q init = softmax(-U)
  std::vector<float> Q((size_t)N * L), logits((size_t)N * L), msg((size_t)N * L), tmp;
  auto softmax_rows = [&](const float* in, float* out) {
    for (int i = 0; i < N; i++) {
      float mx = in[(size_t)i * L];
      for (int l = 1; l < L; l++) mx = std::max(mx, in[(size_t)i * L + l]);
      float s = 0.f;
      for (int l = 0; l < L; l++) {
        float e = std::exp(in[(size_t)i * L + l] - mx);
        out[(size_t)i * L + l] = e;
        s += e;
      }
      for (int l = 0; l < L; l++) out[(size_t)i * L + l] /= s;
    }
  };
  for (int i = 0; i < N * L; i++) logits[i] = -unary[i];
  softmax_rows(logits.data(), Q.data());

  for (int it = 0; it < iters; it++) {
    for (int i = 0; i < N * L; i++) logits[i] = -unary[i];
    for (size_t k = 0; k < kernels.size(); k++) {
      kernels[k]->message(Q.data(), msg.data(), L, tmp);
      // Potts: exponent += w * m(l) (equivalent to -w·Σ_{l'≠l} m(l') up to a
      // per-pixel constant absorbed by the softmax)
      for (int i = 0; i < N * L; i++) logits[i] += kernel_w[k] * msg[i];
    }
    softmax_rows(logits.data(), Q.data());
  }

  std::memcpy(q_out, Q.data(), sizeof(float) * (size_t)N * L);
  for (Kernel* k : kernels) delete k;
}

// ---------------------------------------------------------------------------
// Union-find connected components (8-connectivity)
// ---------------------------------------------------------------------------
struct UnionFind {
  std::vector<int> parent;
  explicit UnionFind(int n) : parent(n) {
    for (int i = 0; i < n; i++) parent[i] = i;
  }
  int find(int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int a, int b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  }
};

}  // namespace

extern "C" {

// Dense-CRF mean-field inference.
//   unary:  [H*W, L] row-major negative log-probabilities
//   rgb:    [H, W, 3] uint8
//   q_out:  [H*W, L] output marginals
//   exact:  1 = O(N²) brute force (test golden), 0 = permutohedral lattice
void wsdl_densecrf(int H, int W, int L, const float* unary, const unsigned char* rgb,
                   float gauss_sxy, float gauss_compat, float bilat_sxy, float bilat_srgb,
                   float bilat_compat, int n_iters, int exact, float* q_out) {
  mean_field(H, W, L, unary, rgb, gauss_sxy, gauss_compat, bilat_sxy, bilat_srgb,
             bilat_compat, n_iters, q_out, exact != 0);
}

// Raw high-dimensional Gaussian filter through the permutohedral lattice:
// positions [N, d], in [N, C] -> out [N, C]. Exposed for parity tests.
void wsdl_permutohedral_filter(int N, int d, int C, const float* positions,
                               const float* in, float* out) {
  Permutohedral lat;
  lat.init(positions, N, d);
  lat.compute(in, out, C);
}

// 8-connected components. labels out: -1 background, else component id
// (ids are the linear index of each component's minimal pixel, matching the
// device implementation in masks/components.py). Returns component count.
int wsdl_label_components(int H, int W, const unsigned char* mask, int32_t* labels) {
  const int N = H * W;
  UnionFind uf(N);
  for (int y = 0; y < H; y++) {
    for (int x = 0; x < W; x++) {
      int i = y * W + x;
      if (!mask[i]) continue;
      // union with already-visited neighbors (W, NW, N, NE)
      if (x > 0 && mask[i - 1]) uf.unite(i, i - 1);
      if (y > 0) {
        if (mask[i - W]) uf.unite(i, i - W);
        if (x > 0 && mask[i - W - 1]) uf.unite(i, i - W - 1);
        if (x < W - 1 && mask[i - W + 1]) uf.unite(i, i - W + 1);
      }
    }
  }
  int count = 0;
  for (int i = 0; i < N; i++) {
    if (!mask[i]) {
      labels[i] = -1;
    } else {
      int r = uf.find(i);
      labels[i] = r;
      if (r == i) count++;
    }
  }
  return count;
}

// Largest-connected-component filter (ref PsuedoMasks.py:15-21 semantics:
// empty masks pass through unchanged).
void wsdl_keep_largest(int H, int W, const unsigned char* mask, unsigned char* out) {
  const int N = H * W;
  std::vector<int32_t> labels(N);
  wsdl_label_components(H, W, mask, labels.data());
  std::unordered_map<int32_t, int> area;
  for (int i = 0; i < N; i++)
    if (labels[i] >= 0) area[labels[i]]++;
  if (area.empty()) {
    std::memcpy(out, mask, N);
    return;
  }
  int32_t best = -1;
  int best_area = -1;
  for (auto& kv : area) {
    if (kv.second > best_area || (kv.second == best_area && kv.first < best)) {
      best = kv.first;
      best_area = kv.second;
    }
  }
  for (int i = 0; i < N; i++) out[i] = labels[i] == best ? 1 : 0;
}

}  // extern "C"
