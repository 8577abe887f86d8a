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
// parameters (colours / sigma_rgb 5 reach 51), so the exponent stays in the
// exact-difference form, sum_k (fq_k - fk_k)^2 in fp32 FMAs. The expanded form
// |fq|^2 + |fk|^2 - 2 fq.fk, which would put the exponent on the tensor cores
// (the TPU kernel splits it into bf16 parts for its matrix unit), cancels at
// that magnitude: about 1e-3 absolute error in the exponent, the error of the
// JAX package's XLA filter off the TPU. The values are accumulated in fp32
// (the TPU kernel's value product runs in bf16); that is closer to the
// float64 golden.
//
// Bound. The function needs per key pair d subtractions, d multiplies, d - 1
// adds, one exp and C multiply-adds: 3d + 2C operations, 5.71 ms at the CRF's
// path shape ([32,50176] queries x [32,12544] keys, d 5, C 2: 2.0e10 pairs,
// far above its 56 MB of bytes) over the fp32 rate. What binds a kernel is
// the instructions it issues per pair: one thread per query that reads each
// key's features with 5 scalar shared-memory loads and calls the accurate
// expf issues about 27 (2.0e10 x 27 / 32 lanes over 132 SMs x 4 schedulers x
// 1.98 GHz: 16 ms), and the exp unit alone (one MUFU.EX2 per pair, 16 per SM
// per clock) needs 4.8 ms.
//
// Design of the CRF's variant (d == 5, C 1 or 2), about 13 issued
// instructions per pair:
//   - A first launch packs each key into 8 floats: its 5 features times
//     s = sqrt(1/2 * log2(e)), its values, zeros. Keys are padded to a
//     multiple of the tile with zero values, which add exactly 0.
//   - Each thread owns ROWS queries (scaled by the same s, in registers),
//     so one key read from shared memory serves ROWS pairs; a key is two
//     broadcast 16-byte loads.
//   - With the scale folded in, the exponent is e = -sum_k (s fq_k - s fk_k)^2,
//     accumulated as fmaf(-t, t, e), and the weight is 2^e: one
//     ex2.approx.ftz (a single MUFU op, relative error about 2^-22, far inside
//     the 1e-4 the filter is held to). The accurate expf and the per-pair
//     multiply by -1/2 are gone.
//   - Key tiles are double-buffered: cp.async stages tile t+1 while tile t
//     is consumed.
// Every thread walks the keys in the same order, so two launches give the
// same bits. Issue still binds it: 13 instructions a pair at 4 a clock per
// SM would take 7.8 ms at the path's shape, and it runs in 9.3 ms on an H100
// SXM at 700 W (against 18.3 for one thread per query with expf); 8 queries
// a thread beat 4 and 2 by 5-7 % there. Any other d or C takes the general
// kernel: one thread per query, its row in shared memory, C in register
// passes of up to MAX_CC, expf.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/bilateral.py). The entry point returns the CUDA
// error of its launches, 0 on success.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int FAST_D = 5;        // the CRF's feature count: [x, y, r, g, b]
constexpr int ROWS = 8;          // queries per thread of the CRF's variant
constexpr int FAST_THREADS = 128;
constexpr int KEY_TILE = 256;    // packed keys per shared-memory tile (8 KB)

constexpr int THREADS = 128;     // general kernel: queries per block, one per thread
constexpr int KT = 128;          // general kernel: keys per shared-memory tile
constexpr int MAX_CC = 8;        // general kernel: value channels per pass

// key j of image b -> packed[b][j] = {s f0, s f1, s f2, s f3}, {s f4, v0, v1, 0}
// (v1 = 0 when C == 1); keys j >= Nk get zero values.
__global__ void pack_keys(const float* __restrict__ fk, const float* __restrict__ v,
                          float4* __restrict__ packed, int Nk, int nk_pad, int C, float s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (j < Nk) {
    const float* f = fk + ((size_t)b * Nk + j) * FAST_D;
    const float* val = v + ((size_t)b * Nk + j) * C;
    lo = make_float4(f[0] * s, f[1] * s, f[2] * s, f[3] * s);
    hi = make_float4(f[4] * s, val[0], C > 1 ? val[1] : 0.f, 0.f);
  }
  float4* out = packed + ((size_t)b * nk_pad + j) * 2;
  out[0] = lo;
  out[1] = hi;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One key tile (KEY_TILE packed keys, 2 float4 each) into shared memory.
__device__ __forceinline__ void stage_tile(float4* dst, const float4* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < KEY_TILE * 2 / FAST_THREADS; ++i) {
    const int at = threadIdx.x + i * FAST_THREADS;
    wsdl::cp_async16(dst + at, src + at);
  }
  wsdl::cp_async_commit();
}

// The CRF's variant: d == 5, CC (1 or 2) value channels, keys packed by
// pack_keys; nk_pad a multiple of KEY_TILE.
template <int CC>
__global__ void __launch_bounds__(FAST_THREADS)
bilateral_packed(const float* __restrict__ fq, const float4* __restrict__ packed,
                 float* __restrict__ out, int Nq, int nk_pad, float s) {
  __shared__ float4 sk[2][KEY_TILE * 2];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * (FAST_THREADS * ROWS) + threadIdx.x;
  const float* fqb = fq + (size_t)b * Nq * FAST_D;
  const float4* kb = packed + (size_t)b * nk_pad * 2;

  float q[ROWS][FAST_D], acc[ROWS][CC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = q0 + r * FAST_THREADS;
#pragma unroll
    for (int k = 0; k < FAST_D; ++k) q[r][k] = i < Nq ? fqb[(size_t)i * FAST_D + k] * s : 0.f;
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
  }

  const int tiles = nk_pad / KEY_TILE;
  if (tiles > 0) stage_tile(sk[0], kb);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      // buffer (t+1)&1 was last read in step t-1, which ended in a barrier
      stage_tile(sk[(t + 1) & 1], kb + (size_t)(t + 1) * KEY_TILE * 2);
      wsdl::cp_async_wait<1>();
    } else {
      wsdl::cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tile = sk[t & 1];
#pragma unroll 4
    for (int j = 0; j < KEY_TILE; ++j) {
      const float4 lo = tile[2 * j], hi = tile[2 * j + 1];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float t0 = q[r][0] - lo.x, e = -t0 * t0;
        t0 = q[r][1] - lo.y;
        e = fmaf(-t0, t0, e);
        t0 = q[r][2] - lo.z;
        e = fmaf(-t0, t0, e);
        t0 = q[r][3] - lo.w;
        e = fmaf(-t0, t0, e);
        t0 = q[r][4] - hi.x;
        e = fmaf(-t0, t0, e);
        const float w = ex2(e);
        acc[r][0] = fmaf(w, hi.y, acc[r][0]);
        if constexpr (CC == 2) acc[r][1] = fmaf(w, hi.z, acc[r][1]);
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is restaged
  }

  float* ob = out + (size_t)b * Nq * CC;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = q0 + r * FAST_THREADS;
    if (i < Nq) {
#pragma unroll
      for (int c = 0; c < CC; ++c) ob[(size_t)i * CC + c] = acc[r][c];
    }
  }
}

// Any d and C: one thread per query, its row in shared memory; C in passes of
// CC channels held in registers (the exponents recomputed for each pass).
template <int CC>
__global__ void __launch_bounds__(THREADS)
bilateral_general(const float* __restrict__ fq, const float* __restrict__ fk,
                  const float* __restrict__ v, float* __restrict__ out, int Nq, int Nk, int d,
                  int C) {
  extern __shared__ float smem[];
  float* sk = smem;           // [KT][d] key features
  float* sv = sk + KT * d;    // [KT][CC] values of this pass's channels
  float* sq = sv + KT * CC;   // [THREADS][d] query rows

  const int b = blockIdx.y;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const bool active = q < Nq;
  const float* fqb = fq + (size_t)b * Nq * d;
  const float* fkb = fk + (size_t)b * Nk * d;
  const float* vb = v + (size_t)b * Nk * C;
  float* ob = out + (size_t)b * Nq * C;

  // each thread reads back only its own row: no barrier needed
  for (int k = 0; k < d; ++k) sq[threadIdx.x * d + k] = active ? fqb[(size_t)q * d + k] : 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    float acc[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[c] = 0.f;

    for (int k0 = 0; k0 < Nk; k0 += KT) {
      const int nk = min(KT, Nk - k0);
      __syncthreads();  // every thread is done with the previous tile
      for (int i = threadIdx.x; i < nk * d; i += THREADS) sk[i] = fkb[(size_t)k0 * d + i];
      for (int i = threadIdx.x; i < nk * CC; i += THREADS) {
        const int key = i / CC, c = c0 + i % CC;
        sv[i] = c < C ? vb[(size_t)(k0 + key) * C + c] : 0.f;
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < nk; ++j) {
          float e = 0.f;
          for (int k = 0; k < d; ++k) {
            const float t = sq[threadIdx.x * d + k] - sk[j * d + k];
            e = fmaf(t, t, e);
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

template <int CC>
int launch_general(const float* fq, const float* fk, const float* v, float* out, int B, int Nq,
                   int Nk, int d, int C, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)KT * d + (size_t)KT * CC + (size_t)THREADS * d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bilateral_general<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Nq + THREADS - 1) / THREADS, B);
  bilateral_general<CC><<<grid, THREADS, smem, s>>>(fq, fk, v, out, Nq, Nk, d, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the packed-key scratch that wsdl_bilateral needs for this call
// (0 when it takes the general kernel).
extern "C" long long wsdl_bilateral_scratch_bytes(int B, int Nk, int d, int C) {
  if (d != FAST_D || C > 2) return 0;
  const long long nk_pad = ((long long)Nk + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
  return (long long)B * nk_pad * 2 * sizeof(float4);
}

// fq [B,Nq,d], fk [B,Nk,d], v [B,Nk,C], out [B,Nq,C]: contiguous float32 on the
// device; scratch: wsdl_bilateral_scratch_bytes(B, Nk, d, C) bytes on the
// device (may be null when that is 0); s: sqrt(1/2 * log2(e)) rounded to
// float, the scale of the CRF's variant; stream: the cudaStream_t to launch
// on. Requires B <= 65535, Nq >= 1, Nk >= 1, C >= 1 and d >= 1 with its
// shared-memory tiles within the card's 227 KB (the wrapper checks d <= 128).
extern "C" int wsdl_bilateral(const void* fq, const void* fk, const void* v, void* out,
                              void* scratch, int B, int Nq, int Nk, int d, int C, float s,
                              void* stream) {
  const float* q = static_cast<const float*>(fq);
  const float* k = static_cast<const float*>(fk);
  const float* val = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == FAST_D && C <= 2) {
    float4* packed = static_cast<float4*>(scratch);
    const int nk_pad = (Nk + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
    if (nk_pad > 0) {  // no keys: the sums are 0
      if (packed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      pack_keys<<<dim3(nk_pad / KEY_TILE, B), KEY_TILE, 0, st>>>(k, val, packed, Nk, nk_pad, C, s);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((Nq + FAST_THREADS * ROWS - 1) / (FAST_THREADS * ROWS), B);
    if (C == 1)
      bilateral_packed<1><<<grid, FAST_THREADS, 0, st>>>(q, packed, o, Nq, nk_pad, s);
    else
      bilateral_packed<2><<<grid, FAST_THREADS, 0, st>>>(q, packed, o, Nq, nk_pad, s);
    return static_cast<int>(cudaGetLastError());
  }
  // any other width: C 1 and C 2 get their own variants, any other C runs
  // passes of MAX_CC, masking the channels >= C
  switch (C) {
    case 1: return launch_general<1>(q, k, val, o, B, Nq, Nk, d, C, st);
    case 2: return launch_general<2>(q, k, val, o, B, Nq, Nk, d, C, st);
    default: return launch_general<MAX_CC>(q, k, val, o, B, Nq, Nk, d, C, st);
  }
}
