// Exact Gaussian-kernel filter of the dense CRF's bilateral message pass, for
// Hopper (sm_90a):
//
//     out[b,i,:] = sum_j exp(-1/2 * |fq[b,i,:] - fk[b,j,:]|^2) * v[b,j,:]
//
// over fq [B,Nq,d], fk [B,Nk,d], v [B,Nk,C] float32 -> out [B,Nq,C] float32.
//
// Replaces the TPU kernels ops/pallas_bilateral.py::_kernel_mxu and
// ::_make_kernel of the JAX package (gaussian_filter_cross). The exponent is
// <= 0, so no running max is needed, unlike softmax attention: the sum over
// keys is a plain sum.
//
// Precision. The features carry |f|^2 of about 7e3 at the reference CRF
// parameters (colours / sigma_rgb 5 reach 51), so the exponent must be exact
// fp32: a reduced-precision product (bf16 on the TPU's matrix unit, TF32 here)
// puts O(10) into it and exp() of that is garbage. The TPU kernel expands the
// square into a split-bf16 matrix product; here each thread sums the squared
// differences in fp32 FMAs, which has no cancellation. expf, not __expf, and
// no fast-math. The values are accumulated in fp32 (the TPU kernel's value
// product runs in bf16); that is closer to the float64 golden.
//
// Design. One thread per query, blocks over (query tile, image). Each block
// stages a tile of KT keys (features and this pass's value channels) in
// shared memory; every thread walks the tile in the same order, so the keys
// of a tile are broadcast reads and two launches give the same bits. At
// d == 5 the query's features live in registers; any other d keeps each
// thread's query row in shared memory. C is done in passes of up to
// MAX_CC channels held in registers; when C > MAX_CC each pass recomputes
// the exponents.
//
// Bound. The function needs per key pair d subtractions, d multiplies, d - 1
// adds, one exp and C multiply-adds: 3d + 2C operations (the kernel also
// multiplies by -1/2 per pair, which could fold into the features). At the
// CRF's path shape ([32,50176] queries x [32,12544] keys, d 5, C 2) that is
// 2.0e10 pairs, far above its 56 MB of bytes. What
// the design does about it: nothing beyond keeping the inner loop to those
// instructions and shared-memory broadcasts; the exponent on the tensor
// cores (a Dekker-split product as on the TPU) is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/bilateral.py). The entry point returns the CUDA
// error of its launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // queries per block, one per thread
constexpr int KT = 128;       // keys per shared-memory tile
constexpr int MAX_CC = 8;     // value channels per pass, held in registers
constexpr int FAST_D = 5;     // the CRF's feature count: [x, y, r, g, b]

// D > 0: the feature count is D and the query's features sit in registers.
// D == 0: any feature count d; each thread keeps its query row in shared memory.
template <int D, int CC>
__global__ void __launch_bounds__(THREADS)
bilateral_filter(const float* __restrict__ fq, const float* __restrict__ fk,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Nq, int Nk, int d, int C) {
  extern __shared__ float smem[];
  const int dd = D > 0 ? D : d;
  float* sk = smem;            // [KT][dd] key features
  float* sv = sk + KT * dd;    // [KT][CC] values of this pass's channels
  float* sq = sv + KT * CC;    // [THREADS][dd] query rows (D == 0 only)

  const int b = blockIdx.y;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const bool active = q < Nq;
  const float* fqb = fq + (size_t)b * Nq * dd;
  const float* fkb = fk + (size_t)b * Nk * dd;
  const float* vb = v + (size_t)b * Nk * C;
  float* ob = out + (size_t)b * Nq * C;

  float qr[D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) qr[k] = active ? fqb[(size_t)q * D + k] : 0.f;
  } else {
    // each thread reads back only its own row: no barrier needed
    for (int k = 0; k < d; ++k)
      sq[threadIdx.x * d + k] = active ? fqb[(size_t)q * d + k] : 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += CC) {
    float acc[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[c] = 0.f;

    for (int k0 = 0; k0 < Nk; k0 += KT) {
      const int nk = min(KT, Nk - k0);
      __syncthreads();  // every thread is done with the previous tile
      for (int i = threadIdx.x; i < nk * dd; i += THREADS) sk[i] = fkb[(size_t)k0 * dd + i];
      for (int i = threadIdx.x; i < nk * CC; i += THREADS) {
        const int key = i / CC, c = c0 + i % CC;
        sv[i] = c < C ? vb[(size_t)(k0 + key) * C + c] : 0.f;
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < nk; ++j) {
          float e = 0.f;
          if constexpr (D > 0) {
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const float t = qr[k] - sk[j * D + k];
              e = fmaf(t, t, e);
            }
          } else {
            for (int k = 0; k < d; ++k) {
              const float t = sq[threadIdx.x * d + k] - sk[j * d + k];
              e = fmaf(t, t, e);
            }
          }
          const float w = expf(-0.5f * e);
#pragma unroll
          for (int c = 0; c < CC; ++c) acc[c] = fmaf(w, sv[j * CC + c], acc[c]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (c0 + c < C) ob[(size_t)q * C + c0 + c] = acc[c];
    }
  }
}

template <int D, int CC>
int launch(const float* fq, const float* fk, const float* v, float* out, int B, int Nq,
           int Nk, int d, int C, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)KT * d + (size_t)KT * CC +
                                       (D > 0 ? 0 : (size_t)THREADS * d));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bilateral_filter<D, CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Nq + THREADS - 1) / THREADS, B);
  bilateral_filter<D, CC><<<grid, THREADS, smem, s>>>(fq, fk, v, out, Nq, Nk, d, C);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const float* fq, const float* fk, const float* v, float* out, int B, int Nq,
             int Nk, int d, int C, cudaStream_t s) {
  // The CRF's two widths (C 1 for the norm, C 2 for the messages) get their own
  // variants; any other C runs passes of MAX_CC, masking the channels >= C.
  switch (C) {
    case 1: return launch<D, 1>(fq, fk, v, out, B, Nq, Nk, d, C, s);
    case 2: return launch<D, 2>(fq, fk, v, out, B, Nq, Nk, d, C, s);
    default: return launch<D, MAX_CC>(fq, fk, v, out, B, Nq, Nk, d, C, s);
  }
}

}  // namespace

// fq [B,Nq,d], fk [B,Nk,d], v [B,Nk,C], out [B,Nq,C]: contiguous float32 on the
// device; stream: the cudaStream_t to launch on. Requires B <= 65535, Nq >= 1,
// C >= 1 and d >= 1 with its shared-memory tiles within the card's 227 KB
// (the wrapper checks d <= 128).
extern "C" int wsdl_bilateral(const void* fq, const void* fk, const void* v, void* out,
                              int B, int Nq, int Nk, int d, int C, void* stream) {
  const float* q = static_cast<const float*>(fq);
  const float* k = static_cast<const float*>(fk);
  const float* val = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == FAST_D) return dispatch<FAST_D>(q, k, val, o, B, Nq, Nk, d, C, s);
  return dispatch<0>(q, k, val, o, B, Nq, Nk, d, C, s);
}
