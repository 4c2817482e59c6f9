// Kernels G and H: the parity-upsample tail from the parity conv outputs.
//
// Replaces vidtok_tpu/ops/pallas/upsample_epilogue.py:49
// parity_blend_interleave (G, pallas_call at :72) and :96
// parity_blend_interleave4 (H, pallas_call at :120), whose shared body
// _kernel (:34) computes, with y_cur and y_prev phase-packed [.., 2C]
// (even | odd output frame) and s the half-rate input [B, T, H, W, C]:
//
//   y         = y_cur[t] + y_prev[t-1] + [bias | bias]        (f32)
//   out[2t+p] = alpha * s[t] + (1 - alpha) * y[pC : (p+1)C]   (rounded once to s's type)
//
// y_prev[-1] is zeros (zero) or y_prev[0] (replicate: the TPU index map
// clamps t-1 to 0). G reads two [B, T, H, W, 2C] tensors; H one
// [B, T, H, W, 4C] tensor [cur 2C | prev 2C] from one C -> 4C conv, which
// the wrapper passes as two sources: the base and the base + 2C, each with
// a row stride of 4C.
//
// Bound on the H100: memory only; per half-rate position it reads C + 4C
// and writes 2C values, with 5 FLOP per output value.
// Design: one thread per 8 channels (16 bytes) of a half-rate position, in
// input order: it reads s once and its two y_cur and two y_prev vectors,
// and writes both output frames, so every load and store is a coalesced
// 16-byte vector. Offsets are 64-bit: a [1, 10, 256, 256, 256] call writes
// 3.4e8 elements. The kernel is a template of the element type, as C's is
// (subpixel.cu): vt_parity_blend_f32 reads and writes f32 (two 16-byte
// vectors per 8 channels), the function in f32 as the TPU kernel gives it
// for f32 inputs.
#include "common.cuh"

namespace {

template <typename T>
__global__ void parity_blend_kernel(const T* __restrict__ s, const T* __restrict__ ycur,
                                    const T* __restrict__ yprev, int ld,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ alpha, T* __restrict__ out,
                                    int T_, int S, int C, int replicate, long long total) {
  const int cv = C / 8;
  const float a = alpha[0];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * 8;
    const long long pos = i / cv;  // (b * T + t) * S + sp
    const long long bt = pos / S;
    const int sp = (int)(pos % S);
    const int t = (int)(bt % T_);
    // the previous frame's row, or none (zero mode at t = 0)
    const long long prev = t > 0 ? pos - S : (replicate ? pos : -1);
    float sv[8], y[2][8];
    vt::ld8(s + pos * C + c, sv);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      vt::ld8(ycur + pos * ld + p * C + c, y[p]);
      if (prev >= 0) {
        float f[8];
        vt::ld8(yprev + prev * ld + p * C + c, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[p][e] += f[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[p][e] = a * sv[e] + (1.f - a) * (y[p][e] + bias[c + e]);
      vt::st8(out + ((2 * bt + p) * S + sp) * C + c, y[p]);
    }
  }
}

template <typename T>
int launch_blend(const void* s, const void* ycur, const void* yprev, const void* bias,
                 const void* alpha, void* out, int ld, int B, int T_, int S, int C,
                 int replicate, void* stream) {
  const long long total = (long long)B * T_ * S * (C / 8);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  parity_blend_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(ycur), static_cast<const T*>(yprev),
      ld, static_cast<const float*>(bias), static_cast<const float*>(alpha),
      static_cast<T*>(out), T_, S, C, replicate, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vt_parity_blend(const void* s, const void* ycur,
                               const void* yprev, const void* bias,
                               const void* alpha, void* out, int ld, int B,
                               int T, int S, int C, int replicate,
                               void* stream) {
  return launch_blend<__nv_bfloat16>(s, ycur, yprev, bias, alpha, out, ld, B, T, S, C,
                                     replicate, stream);
}

// G and H on f32 activations: the same sum, bias and blend in f32, the
// output not rounded.
extern "C" int vt_parity_blend_f32(const void* s, const void* ycur, const void* yprev,
                                   const void* bias, const void* alpha, void* out, int ld,
                                   int B, int T, int S, int C, int replicate, void* stream) {
  return launch_blend<float>(s, ycur, yprev, bias, alpha, out, ld, B, T, S, C, replicate,
                             stream);
}
