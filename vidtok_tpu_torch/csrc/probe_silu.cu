// T4: the bf16 SiLU probe, the counterpart of the Pallas kernel of the JAX
// package's tools/probe_silu_bf16.py:48 run (pallas_call at :51, body
// make_kernel at :30). y = silu(x) over a bf16 tensor, in three forms:
//
//   mode 0, f32_logistic: x * sigmoid(x) in f32, rounded once to bf16
//           (an ex2 and a divide per value);
//   mode 1, bf16_tanh:    x * bf16(0.5 * (tanh(0.5 x) + 1)), every step in
//           bf16x2 arithmetic, tanh.approx.bf16x2 (one instruction for two
//           values);
//   mode 2, bf16_logistic: x * 1 / (1 + exp(-x)), every step in bf16x2
//           (h2exp, h2rcp).
//
// On the TPU the question was which form its vector unit lowers (Mosaic
// refused bf16 logistic) and how fast; on Hopper all three compile, and the
// question is which instructions keep up with the memory. Bound: bytes, 2
// read and 2 written per value; the ~5 operations per value are far under
// the card's vector rate. Design: one thread per 8 values, 16-byte loads and
// stores, one pass over the tensor.
#include "common.cuh"

namespace {

__device__ __forceinline__ __nv_bfloat162 tanh_bf16x2(__nv_bfloat162 x) {
  unsigned xi = *reinterpret_cast<unsigned*>(&x), yi;
  asm("tanh.approx.bf16x2 %0, %1;" : "=r"(yi) : "r"(xi));
  return *reinterpret_cast<__nv_bfloat162*>(&yi);
}

__device__ __forceinline__ __nv_bfloat162 silu_tanh(__nv_bfloat162 x) {
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f), one = __float2bfloat162_rn(1.f);
  return __hmul2(x, __hmul2(half, __hadd2(tanh_bf16x2(__hmul2(x, half)), one)));
}

__device__ __forceinline__ __nv_bfloat162 silu_logistic(__nv_bfloat162 x) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
  return __hmul2(x, h2rcp(__hadd2(one, h2exp(__hneg2(x)))));
}

template <int MODE>
__global__ void silu_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                            long long n8) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  uint4 v = x[i];
  if (MODE == 0) {
    float f[8];
    vt::unpack8(v, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = f[e] / (1.f + __expf(-f[e]));
    v = vt::pack8(f);
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = MODE == 1 ? silu_tanh(h[k]) : silu_logistic(h[k]);
  }
  out[i] = v;
}

}  // namespace

// n values, n % 8 == 0; mode as above.
extern "C" int vt_silu_probe(const void* x, void* out, long long n, int mode,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n8 = n / 8;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n8 + threads - 1) / threads);
  const auto* xv = static_cast<const uint4*>(x);
  auto* ov = static_cast<uint4*>(out);
  if (mode == 0)
    silu_kernel<0><<<blocks, threads, 0, s>>>(xv, ov, n8);
  else if (mode == 1)
    silu_kernel<1><<<blocks, threads, 0, s>>>(xv, ov, n8);
  else
    silu_kernel<2><<<blocks, threads, 0, s>>>(xv, ov, n8);
  return (int)cudaGetLastError();
}
