// Kernels C and I: subpixel-upsample bias + interleave.
//
// C replaces vidtok_tpu/ops/pallas/subpixel_epilogue.py:100
// subpixel_interleave (pallas_call at :116):
//
//   out[n, 2a+pr, 2b+pc, :] = y_{pr,pc}[n, a, b, :] + bias   (bias in bf16)
//
// y_pq: [N, H, W, C] bf16, the four 2x2 parity convs of SpatialUpsample.
// I replaces :57 subpixel_interleave_z (pallas_call at :86), the merged
// form: z [N, H+1, W+1, 4C] is one VALID 2x2 conv of the once-padded input
// with the four parity kernels on output-channel groups e00|e01|e10|e11,
//
//   out[n, 2a+pr, 2b+pc, :] = z[n, a+pr, b+pc, (2pr+pc)C : (2pr+pc+1)C] + bias
//
// Bound on the H100: memory only; each reads every input element it needs
// once (I needs 4HWC of z's 4(H+1)(W+1)C) and writes each output once.
// Design: one thread per 8 channels (16 bytes) of an output position, in
// output order, so stores are fully coalesced and each load is a 16-byte
// vector from one of the four sources (C) or channel groups (I). The TPU
// kernels' row-parity output layout (a VMEM relayout workaround) does not
// carry over. C and I are templates of the element type:
// vt_subpixel_interleave_f32 and vt_subpixel_interleave_z_f32 read and
// write f32 (two 16-byte vectors per 8 channels) and add the bias in f32,
// the tile dtype.
#include "common.cuh"

namespace {

// The bias in the tile dtype, as the TPU kernel adds it.
__device__ __forceinline__ float tile_bias(float b, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(b));
}
__device__ __forceinline__ float tile_bias(float b, const float*) { return b; }

template <typename T>
__global__ void subpixel_kernel(const T* __restrict__ y00, const T* __restrict__ y01,
                                const T* __restrict__ y10, const T* __restrict__ y11,
                                const float* __restrict__ bias, T* __restrict__ out, int N,
                                int H, int W, int C) {
  const int cv = C / 8;
  const long long total = (long long)N * 2 * H * 2 * W * cv;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * 8;
    const long long pix = i / cv;
    const int ox = (int)(pix % (2 * W));
    const long long r = pix / (2 * W);
    const int oy = (int)(r % (2 * H));
    const long long n = r / (2 * H);
    const int pr = oy & 1, pc = ox & 1;
    const T* y = pr ? (pc ? y11 : y10) : (pc ? y01 : y00);
    float f[8];
    vt::ld8(y + ((n * H + (oy >> 1)) * W + (ox >> 1)) * C + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] += tile_bias(bias[c + e], y);
    vt::st8(out + i * 8, f);
  }
}

template <typename T>
__global__ void subpixel_z_kernel(const T* __restrict__ z, const float* __restrict__ bias,
                                  T* __restrict__ out, int N, int H, int W, int C) {
  const int cv = C / 8;
  const long long total = (long long)N * 2 * H * 2 * W * cv;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * 8;
    const long long pix = i / cv;
    const int ox = (int)(pix % (2 * W));
    const long long r = pix / (2 * W);
    const int oy = (int)(r % (2 * H));
    const long long n = r / (2 * H);
    const int pr = oy & 1, pc = ox & 1;
    const long long row = (n * (H + 1) + (oy >> 1) + pr) * (W + 1) + (ox >> 1) + pc;
    float f[8];
    vt::ld8(z + row * 4 * C + (2 * pr + pc) * C + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] += tile_bias(bias[c + e], z);
    vt::st8(out + i * 8, f);
  }
}

int grid_for(long long total, int threads) {
  const long long want = (total + threads - 1) / threads;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

template <typename T>
int launch_z(const void* z, const void* bias, void* out, int N, int H, int W, int C,
             void* stream) {
  const int threads = 256;
  const int blocks = grid_for((long long)N * 4 * H * W * (C / 8), threads);
  subpixel_z_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const float*>(bias), static_cast<T*>(out), N, H,
      W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vt_subpixel_interleave(const void* y00, const void* y01,
                                      const void* y10, const void* y11,
                                      const void* bias, void* out, int N,
                                      int H, int W, int C, void* stream) {
  const int threads = 256;
  const int blocks = grid_for((long long)N * 4 * H * W * (C / 8), threads);
  subpixel_kernel<__nv_bfloat16><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y00),
      static_cast<const __nv_bfloat16*>(y01),
      static_cast<const __nv_bfloat16*>(y10),
      static_cast<const __nv_bfloat16*>(y11), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), N, H, W, C);
  return (int)cudaGetLastError();
}

extern "C" int vt_subpixel_interleave_z(const void* z, const void* bias,
                                        void* out, int N, int H, int W, int C,
                                        void* stream) {
  return launch_z<__nv_bfloat16>(z, bias, out, N, H, W, C, stream);
}

extern "C" int vt_subpixel_interleave_z_f32(const void* z, const void* bias, void* out, int N,
                                            int H, int W, int C, void* stream) {
  return launch_z<float>(z, bias, out, N, H, W, C, stream);
}

extern "C" int vt_subpixel_interleave_f32(const void* y00, const void* y01,
                                          const void* y10, const void* y11,
                                          const void* bias, void* out, int N,
                                          int H, int W, int C, void* stream) {
  const int threads = 256;
  const int blocks = grid_for((long long)N * 4 * H * W * (C / 8), threads);
  subpixel_kernel<float><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y00), static_cast<const float*>(y01),
      static_cast<const float*>(y10), static_cast<const float*>(y11),
      static_cast<const float*>(bias), static_cast<float*>(out), N, H, W, C);
  return (int)cudaGetLastError();
}
