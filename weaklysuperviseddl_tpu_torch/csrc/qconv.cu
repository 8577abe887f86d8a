// The two per-layer passes around the int32 GEMM of an int8 convolution, for
// Hopper (sm_90a). The port's int8 serving (ops/quant.py) runs every conv and
// matmul site of DeepLabV3 as
//
//     Q1 quantize_gather:  fp32 activation [B,H,W,C] (NHWC)  -> int8 patches [Mp,Kp]
//        GEMM (torch._int_mm, cuBLASLt):  [Mp,Kp] x [Kp,Np]   -> int32 [Mp,Np]
//     Q2 dequant_epilogue: int32 [Mp,Np] -> fp32 out [B,Ho,Wo,N] (written, or
//                          added into a region of it), and the BatchNorm
//                          that follows the conv
//
// No TPU kernel is replaced: in the JAX package (ops/quant.py, Int8Quantizer.
// build) the int8 convolution is XLA's conv_general_dilated with int32
// accumulation. The arithmetic follows it exactly:
//
//   Q1  q = clip(rint(x * inv), -127, 127), x * inv one float32 multiply
//       (inv = float32(1 / s_x), as JAX's _quantize_act), rint rounding half
//       to even as jnp.round. Row m = ((b*Ho + oy)*Wo + ox) is output pixel
//       (b, oy, ox); column k = ((ky*kw + kx)*C + c) reads input pixel
//       (y0 + oy*stride - pad + ky*dil, x0 + ox*stride - pad + kx*dil),
//       channel c, and 0 in the padding. (y0, x0) is the origin of a source
//       region: an ASPP tap is a 1x1 "conv" over its in-bounds region. Rows
//       M..Mp-1 and columns K..Kp-1 are 0 (the GEMM's padding).
//   Q2  v = float(acc) * rescale[n] (rescale = s_w[n] * s_x in float32, as
//       JAX's epilogue), + bias[n] where given (the conv's bias add); v, or
//       out + v for a tap, whose contributions JAX adds in order iy, ix (one
//       launch a tap, in order on the stream); then, where given, the eval
//       BatchNorm that takes the conv's output, in flax's order:
//       (v - mean[n]) * mul[n] + beta[n], mul = rsqrt(var + eps) * scale.
//       Each step is a separately rounded float32 operation (__fmul_rn,
//       __fadd_rn, __fsub_rn: no FMA contraction), so the plain version on
//       the CPU gives the same bits, and with it the whole int8 program: its
//       other float steps (ReLU, residual adds, max-pool) are exact.
//
// Bound. Both passes are bytes: Q1 reads the activation once (4 bytes an
// element) and writes the patch matrix once (1 byte an entry), Q2 reads the
// accumulator (4 bytes) and writes (or reads and writes) the output. A torch
// version (fp32 unfold, a quantize pass, a cast) moves about 4x Q1's bytes.
// What the design does about it: one thread writes 16 bytes of a row of
// patches (4 where C % 16 != 0) from 16-byte float4 loads of C-contiguous
// NHWC pixels, neighbouring threads on neighbouring columns, so that both
// sides are coalesced; Q2 moves 16 bytes a thread where N % 4 == 0. Every
// output is a pure function of its inputs: two launches give the same bits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (ops/qconv.py). The entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Gather {
  int B, H, W, C;  // input [B,H,W,C], contiguous
  int Ho, Wo;      // output pixels an image
  int kh, kw, stride, pad, dil;
  int y0, x0;      // origin of the source region
  int K, Kp;       // K = kh*kw*C columns, padded to Kp
  int M, Mp;       // M = B*Ho*Wo rows, padded to Mp
};

__device__ __forceinline__ uint32_t q8(float v, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// One thread: V consecutive columns k0..k0+V-1 of row m (V = 4 or 16).
// VEC: C % V == 0 and x 16-byte aligned, so the V columns are channels
// c0..c0+V-1 of one input pixel, read as float4s.
template <int V, bool VEC>
__global__ void __launch_bounds__(THREADS) quantize_gather(const float* __restrict__ x,
                                                           int8_t* __restrict__ a, Gather g,
                                                           float inv) {
  // 32-bit indices: the wrapper keeps Mp*Kp below 2^31
  const int groups_row = g.Kp / V;
  const int i = static_cast<int>(blockIdx.x) * THREADS + static_cast<int>(threadIdx.x);
  if (i >= g.Mp * groups_row) return;
  const int m = i / groups_row;
  const int k0 = (i - m * groups_row) * V;
  uint32_t word[V / 4];
#pragma unroll
  for (int w = 0; w < V / 4; ++w) word[w] = 0;
  if (m < g.M && k0 < g.K) {
    const int ox = m % g.Wo;
    const int t = m / g.Wo;
    const int oy = t % g.Ho;
    const int b = t / g.Ho;
    const int iy0 = g.y0 + oy * g.stride - g.pad;
    const int ix0 = g.x0 + ox * g.stride - g.pad;
    if constexpr (VEC) {
      const int c0 = k0 % g.C;
      const int tap = k0 / g.C;
      const int iy = iy0 + (tap / g.kw) * g.dil;
      const int ix = ix0 + (tap % g.kw) * g.dil;
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
        const float4* p = reinterpret_cast<const float4*>(
            x + ((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.C + c0);
#pragma unroll
        for (int w = 0; w < V / 4; ++w) {
          const float4 v = __ldg(p + w);
          word[w] = q8(v.x, inv) | q8(v.y, inv) << 8 | q8(v.z, inv) << 16 | q8(v.w, inv) << 24;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = k0 + j;
        if (k >= g.K) break;
        const int c = k % g.C;
        const int tap = k / g.C;
        const int iy = iy0 + (tap / g.kw) * g.dil;
        const int ix = ix0 + (tap % g.kw) * g.dil;
        if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
          word[j / 4] |= q8(__ldg(x + ((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.C + c),
                            inv)
                         << (8 * (j % 4));
      }
    }
  }
  int8_t* dst = a + static_cast<long long>(m) * g.Kp + k0;
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(word[0], word[1], word[2], word[3]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = word[0];
  }
}

struct Epilogue {
  int M, N, Np;         // rows of acc used, output channels, acc's row stride
  int h, w;             // the region's pixels an image (M = B*h*w)
  int outH, outW;       // the output image [B,outH,outW,N]
  int oy0, ox0;         // the region's origin in it
};

struct Norm {             // the eval BatchNorm after the conv, or all null
  const float* mean;
  const float* mul;
  const float* beta;
};

__device__ __forceinline__ float dequant(int acc, float rescale, const float* bias, int n) {
  float v = __fmul_rn(__int2float_rn(acc), rescale);
  if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + n));
  return v;
}

__device__ __forceinline__ float normalize(float v, const Norm& bn, int n) {
  if (bn.mean == nullptr) return v;
  return __fadd_rn(__fmul_rn(__fsub_rn(v, __ldg(bn.mean + n)), __ldg(bn.mul + n)),
                   __ldg(bn.beta + n));
}

// One thread: V consecutive channels n0..n0+V-1 of row m (V = 4 where
// N % 4 == 0 and Np % 4 == 0, else 1).
template <int V, bool ACCUMULATE>
__global__ void __launch_bounds__(THREADS) dequant_epilogue(const int* __restrict__ acc,
                                                            float* __restrict__ out,
                                                            const float* __restrict__ rescale,
                                                            const float* __restrict__ bias,
                                                            Norm bn, Epilogue e) {
  // 32-bit indices: the wrapper keeps M*Np below 2^31
  const int groups_row = e.N / V;
  const int i = static_cast<int>(blockIdx.x) * THREADS + static_cast<int>(threadIdx.x);
  if (i >= e.M * groups_row) return;
  const int m = i / groups_row;
  const int n0 = (i - m * groups_row) * V;
  const int x = m % e.w;
  const int t = m / e.w;
  const int y = t % e.h;
  const int b = t / e.h;
  float* o = out + ((static_cast<long long>(b) * e.outH + e.oy0 + y) * e.outW + e.ox0 + x) * e.N + n0;
  const int* src = acc + static_cast<long long>(m) * e.Np + n0;
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(src));
    const float4 r = __ldg(reinterpret_cast<const float4*>(rescale + n0));
    float4 v = make_float4(dequant(q.x, r.x, bias, n0), dequant(q.y, r.y, bias, n0 + 1),
                           dequant(q.z, r.z, bias, n0 + 2), dequant(q.w, r.w, bias, n0 + 3));
    if constexpr (ACCUMULATE) {
      const float4 prev = *reinterpret_cast<const float4*>(o);
      v = make_float4(__fadd_rn(prev.x, v.x), __fadd_rn(prev.y, v.y), __fadd_rn(prev.z, v.z),
                      __fadd_rn(prev.w, v.w));
    }
    *reinterpret_cast<float4*>(o) = make_float4(normalize(v.x, bn, n0), normalize(v.y, bn, n0 + 1),
                                                normalize(v.z, bn, n0 + 2),
                                                normalize(v.w, bn, n0 + 3));
  } else {
    float v = dequant(__ldg(src), __ldg(rescale + n0), bias, n0);
    if constexpr (ACCUMULATE) v = __fadd_rn(*o, v);
    *o = normalize(v, bn, n0);
  }
}

inline unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + THREADS - 1) / THREADS);
}

}  // namespace

// x: float32 [B,H,W,C] contiguous on the device; a: int8 [Mp,Kp] contiguous.
// Requires Kp % 16 == 0, K = kh*kw*C <= Kp, M = B*Ho*Wo <= Mp, Mp*Kp < 2^31
// and B*H*W*C < 2^31 (the wrapper checks). inv: the float32 multiplier
// 1/s_x. stream: the cudaStream_t to launch on.
extern "C" int wsdl_quantize_gather(const void* x, void* a, int B, int H, int W, int C, int Ho,
                                    int Wo, int kh, int kw, int stride, int pad, int dil, int y0,
                                    int x0, int Kp, int Mp, float inv, void* stream) {
  const Gather g{B, H, W, C, Ho, Wo, kh, kw, stride, pad, dil, y0, x0, kh * kw * C, Kp,
                 B * Ho * Wo, Mp};
  if (Kp % 16 || g.K > Kp || g.M > Mp || B < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  int8_t* ap = static_cast<int8_t*>(a);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (aligned && C % 16 == 0) {
    quantize_gather<16, true><<<blocks_for(static_cast<long long>(Mp) * (Kp / 16)), THREADS, 0, s>>>(
        xp, ap, g, inv);
  } else if (aligned && C % 4 == 0) {
    quantize_gather<4, true><<<blocks_for(static_cast<long long>(Mp) * (Kp / 4)), THREADS, 0, s>>>(
        xp, ap, g, inv);
  } else {
    quantize_gather<4, false><<<blocks_for(static_cast<long long>(Mp) * (Kp / 4)), THREADS, 0, s>>>(
        xp, ap, g, inv);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc: int32 [>= M, Np] contiguous; out: float32 [B,outH,outW,N] contiguous,
// its region [oy0, oy0+h) x [ox0, ox0+w) written (accumulate = 0) or added
// into (accumulate = 1); rescale [N], bias [N] (or null) and the BatchNorm's
// mean, mul and beta [N] (all three or none) float32. Requires N <= Np and
// M*Np < 2^31 (the wrapper checks).
extern "C" int wsdl_dequant_epilogue(const void* acc, void* out, const void* rescale,
                                     const void* bias, const void* bn_mean, const void* bn_mul,
                                     const void* bn_beta, int M, int N, int Np, int h, int w,
                                     int outH, int outW, int oy0, int ox0, int accumulate,
                                     void* stream) {
  const Epilogue e{M, N, Np, h, w, outH, outW, oy0, ox0};
  const Norm bn{static_cast<const float*>(bn_mean), static_cast<const float*>(bn_mul),
                static_cast<const float*>(bn_beta)};
  if (N < 1 || N > Np || h < 1 || w < 1 || M % (h * w) || oy0 + h > outH || ox0 + w > outW ||
      (bn.mean == nullptr) != (bn.mul == nullptr) || (bn.mean == nullptr) != (bn.beta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ap = static_cast<const int*>(acc);
  float* op = static_cast<float*>(out);
  const float* rp = static_cast<const float*>(rescale);
  const float* bp = static_cast<const float*>(bias);
  const bool vec = N % 4 == 0 && Np % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rescale) % 16 == 0;
  const long long items = static_cast<long long>(M) * (vec ? N / 4 : N);
  if (items == 0) return static_cast<int>(cudaSuccess);
  if (vec && accumulate) {
    dequant_epilogue<4, true><<<blocks_for(items), THREADS, 0, s>>>(ap, op, rp, bp, bn, e);
  } else if (vec) {
    dequant_epilogue<4, false><<<blocks_for(items), THREADS, 0, s>>>(ap, op, rp, bp, bn, e);
  } else if (accumulate) {
    dequant_epilogue<1, true><<<blocks_for(items), THREADS, 0, s>>>(ap, op, rp, bp, bn, e);
  } else {
    dequant_epilogue<1, false><<<blocks_for(items), THREADS, 0, s>>>(ap, op, rp, bp, bn, e);
  }
  return static_cast<int>(cudaGetLastError());
}
