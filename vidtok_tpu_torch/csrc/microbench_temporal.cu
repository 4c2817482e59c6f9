// The temporal-resblock microbenchmark's kernels T1-T3, the counterparts of
// the Pallas kernels of the JAX package's tools/microbench_temporal.py, over
// x [B, T, S = H*W, C] bf16.
//
// T3 replaces :130 copy_min (pallas_call at :140), the TPU's copy floor:
// out = x, one unit at a time, a unit being tile_t frames x tile_s positions
// x C channels. Bound: bytes (x read and written once). Design: a unit is
// tile_t runs of tile_s * C contiguous values, one per frame; each run is
// cut into 16 KB pieces, one per 256-thread block with four 16-byte loads in
// flight per thread, so even the (tile_t 1, tile_s 4096) tiling of
// [1, 9, 4096, 512], 9 units, puts 2304 blocks on the 132 SMs. Blocks are
// numbered unit by unit, in the TPU grid's order; the card has no per-step
// VMEM buffer to size, so the tiling only orders the work.
//
// T2 replaces :102 fused_diag (pallas_call at :111, body :81), in three
// modes:
//   copy: out = x, T3's copy with one unit per clip;
//   mm:   h = bf16(conv1_t(x)), out = x + conv2_t(h), the two causal k=3
//         time convs with a zero front, no bias and no LN: the wmma loop's
//         implicit GEMM (igemm_conv.cuh, kTemporal; kernel B itself now runs
//         the wgmma loop of wgmma_conv.cuh) twice, given a zero bias
//         vector, with the residual in the second epilogue. Bound:
//         operations at C = 512 (12 C^2 FLOP per position), bytes at 128;
//   ln:   a1 = bf16(ln_silu(x; norm1)), a2 = bf16(ln_silu(a1; norm2)),
//         out = x + a2, the exact LN+SiLU. Both passes work per position, so
//         one warp holds a row in registers and does both and the residual
//         in one pass. Bound: bytes.
//
// T1 replaces :53 fused_fat (pallas_call at :62): kernel B in zero mode with
// the exact LN+SiLU, the three time taps of each conv concatenated into one
// [M, 3C] x [3C, C] product. Bound: operations at C = 512, as B's. Design:
// the TPU's question, one fat product or three accumulated taps, asked of
// the card. A row pass writes each activated row into the three places of
// the fat operand [a(t-2) | a(t-1) | a(t)] (zeros before frame 0; a [M, 3C]
// bf16 scratch); the wmma loop as a dense GEMM (kDense) adds the bias
// and writes h in f32, because the TPU kernel's second LN reads h unrounded;
// the row pass again, from h; the dense GEMM adds the bias and x. Kernel B
// gives the other answer: implicit taps, nothing materialised.
#include "igemm_conv.cuh"

namespace {

constexpr int kCopyThreads = 256, kCopyVec = 4;  // 16 KB per block
constexpr int kRowWarps = 8;

// out = x over the units of a [B, T, S, C] tensor (C8 = C / 8 vectors per
// position): block id = ((unit * tile_t + frame) * pieces + piece), unit =
// (b, t // tile_t, s // tile_s) with the last fastest.
__global__ void copy_units_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                  int T, int S, int C8, int tile_t, int tile_s,
                                  int nt, int ns, long long pieces) {
  const long long bid = blockIdx.x;
  const long long piece = bid % pieces, fr = bid / pieces;
  const int f = (int)(fr % tile_t);
  const long long unit = fr / tile_t;
  const int ks = (int)(unit % ns);
  const long long rest = unit / ns;
  const int kt = (int)(rest % nt);
  const long long b = rest / nt;
  const long long run = (long long)tile_s * C8;
  const long long start =
      ((b * T + (long long)kt * tile_t + f) * S + (long long)ks * tile_s) * C8;
  const long long v0 = piece * (kCopyThreads * kCopyVec) + threadIdx.x;
  uint4 r[kCopyVec];
#pragma unroll
  for (int k = 0; k < kCopyVec; ++k)
    if (v0 + k * kCopyThreads < run) r[k] = x[start + v0 + k * kCopyThreads];
#pragma unroll
  for (int k = 0; k < kCopyVec; ++k)
    if (v0 + k * kCopyThreads < run) out[start + v0 + k * kCopyThreads] = r[k];
}

void launch_copy(const void* x, void* out, int B, int T, int S, int C, int tile_t,
                 int tile_s, cudaStream_t s) {
  const int nt = T / tile_t, ns = S / tile_s;
  const long long run = (long long)tile_s * (C / 8);
  const long long pieces = (run + kCopyThreads * kCopyVec - 1) / (kCopyThreads * kCopyVec);
  const long long blocks = (long long)B * nt * ns * tile_t * pieces;
  copy_units_kernel<<<(unsigned)blocks, kCopyThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), T, S, C / 8, tile_t,
      tile_s, nt, ns, pieces);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  vt::unpack8(vt::ld_u4(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// Row p of C channels into registers, as row_stats_exact lays it out.
template <int NV, typename In>
__device__ __forceinline__ void load_row(const In* p, int C, int lane, float (&v)[NV][8]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 256 * i + 8 * lane;
    if (c < C) load8(p + c, v[i]);
  }
}

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16(f));
}

// For row = (b, t, s) of src [B, T, S, C]: a = bf16(ln_silu_exact_f32(src[row]))
// is written to the fat operand fat [B*T*S, 3C] in column block 2 of row
// (b, t, s), block 1 of (b, t+1, s) and block 0 of (b, t+2, s), where those
// frames exist; the blocks of frames 0 and 1 that no frame fills (taps
// before frame 0) are zeroed. One warp per row; C <= 256 * NV.
template <int NV, typename In>
__global__ void fat_rows_kernel(const In* __restrict__ src, const float* __restrict__ g,
                                const float* __restrict__ b, __nv_bfloat16* __restrict__ fat,
                                int T, int S, int C, long long rows) {
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const int t = (int)((row / S) % T);
  float v[NV][8];
  load_row(src + row * C, C, lane, v);
  const float2 st = vt::row_stats_exact(v, C, lane);
  const long long ld = 3LL * C;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 256 * i + 8 * lane;
    if (c >= C) continue;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = vt::ln_silu_exact_f32(v[i][e], st.x, st.y, g[c + e], b[c + e]);
    const uint4 a = vt::pack8(f);
    __nv_bfloat16* p = fat + row * ld + c;
    *reinterpret_cast<uint4*>(p + 2 * C) = a;
    if (t + 1 < T) *reinterpret_cast<uint4*>(p + S * ld + C) = a;
    if (t + 2 < T) *reinterpret_cast<uint4*>(p + 2 * S * ld) = a;
    if (t < 2) *reinterpret_cast<uint4*>(p) = zero;
    if (t < 1) *reinterpret_cast<uint4*>(p + C) = zero;
  }
}

template <typename In>
void launch_fat_rows(const In* src, const void* g, const void* b, __nv_bfloat16* fat,
                     int T, int S, int C, long long rows, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
  const auto* gf = static_cast<const float*>(g);
  const auto* bf = static_cast<const float*>(b);
  if (C <= 256)
    fat_rows_kernel<1, In><<<blocks, kRowWarps * 32, 0, s>>>(src, gf, bf, fat, T, S, C, rows);
  else if (C <= 512)
    fat_rows_kernel<2, In><<<blocks, kRowWarps * 32, 0, s>>>(src, gf, bf, fat, T, S, C, rows);
  else
    fat_rows_kernel<4, In><<<blocks, kRowWarps * 32, 0, s>>>(src, gf, bf, fat, T, S, C, rows);
}

// out[row] = bf16(x + a2), a2 = bf16(ln_silu_exact_f32(a1; g2, b2)),
// a1 = bf16(ln_silu_exact_f32(x; g1, b1)): one warp per row, in registers.
template <int NV>
__global__ void ln_twice_kernel(const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ g1, const float* __restrict__ b1,
                                const float* __restrict__ g2, const float* __restrict__ b2,
                                __nv_bfloat16* __restrict__ out, int C, long long rows) {
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  float v[NV][8], a[NV][8];
  load_row(x + row * C, C, lane, v);
  const float2 s1 = vt::row_stats_exact(v, C, lane);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 256 * i + 8 * lane;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      a[i][e] = c < C ? round_bf16(vt::ln_silu_exact_f32(v[i][e], s1.x, s1.y, g1[c + e], b1[c + e]))
                      : 0.f;
  }
  const float2 s2 = vt::row_stats_exact(a, C, lane);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 256 * i + 8 * lane;
    if (c >= C) continue;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = v[i][e] + round_bf16(vt::ln_silu_exact_f32(a[i][e], s2.x, s2.y, g2[c + e], b2[c + e]));
    *reinterpret_cast<uint4*>(out + row * C + c) = vt::pack8(f);
  }
}

void launch_ln_twice(const __nv_bfloat16* x, const float* g1, const float* b1,
                     const float* g2, const float* b2, __nv_bfloat16* out, int C,
                     long long rows, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + kRowWarps - 1) / kRowWarps);
  if (C <= 256)
    ln_twice_kernel<1><<<blocks, kRowWarps * 32, 0, s>>>(x, g1, b1, g2, b2, out, C, rows);
  else if (C <= 512)
    ln_twice_kernel<2><<<blocks, kRowWarps * 32, 0, s>>>(x, g1, b1, g2, b2, out, C, rows);
  else
    ln_twice_kernel<4><<<blocks, kRowWarps * 32, 0, s>>>(x, g1, b1, g2, b2, out, C, rows);
}

}  // namespace

// T3: C % 8 == 0, tile_t | T, tile_s | S.
extern "C" int vt_copy_units(const void* x, void* out, int B, int T, int S, int C,
                             int tile_t, int tile_s, void* stream) {
  launch_copy(x, out, B, T, S, C, tile_t, tile_s, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// T2: mode 0 copy, 1 mm, 2 ln. mm: C % 128 == 0, h a [B, T, S, C] scratch,
// zero_bias C zeros; ln: C % 8 == 0, C <= 1024.
extern "C" int vt_microbench_diag(const void* x, void* out, void* h, const void* g1,
                                  const void* b1, const void* w1, const void* g2,
                                  const void* b2, const void* w2, const void* zero_bias,
                                  int B, int T, int S, int C, int mode, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (mode == 0) {
    launch_copy(x, out, B, T, S, C, T, S, s);
  } else if (mode == 1) {
    const igemm::Geometry geo{T, S};
    const auto* zb = static_cast<const float*>(zero_bias);
    auto* hb = static_cast<__nv_bfloat16*>(h);
    const igemm::Params p1{xb, static_cast<const __nv_bfloat16*>(w1), zb, nullptr, nullptr,
                           hb, M, C, C, 0};
    igemm::launch_conv<igemm::kTemporal>(p1, geo, s);
    const igemm::Params p2{hb, static_cast<const __nv_bfloat16*>(w2), zb, nullptr, xb, ob,
                           M, C, C, 0};
    igemm::launch_conv<igemm::kTemporal>(p2, geo, s);
  } else {
    launch_ln_twice(xb, static_cast<const float*>(g1), static_cast<const float*>(b1),
                    static_cast<const float*>(g2), static_cast<const float*>(b2), ob, C, M,
                    s);
  }
  return (int)cudaGetLastError();
}

// T1: C % 128 == 0, C <= 1024; fat a [B*T*S, 3C] bf16 scratch, h a
// [B*T*S, C] f32 scratch; w1, w2 [3C, C] tap-major.
extern "C" int vt_microbench_fat(const void* x, void* out, void* fat, void* h,
                                 const void* g1, const void* b1, const void* w1,
                                 const void* bias1, const void* g2, const void* b2,
                                 const void* w2, const void* bias2, int B, int T, int S,
                                 int C, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* fb = static_cast<__nv_bfloat16*>(fat);
  auto* hf = static_cast<float*>(h);
  const igemm::Geometry dense{1, 1};

  launch_fat_rows(xb, g1, b1, fb, T, S, C, M, s);
  igemm::Params p1{fb, static_cast<const __nv_bfloat16*>(w1),
                   static_cast<const float*>(bias1), nullptr, nullptr, nullptr, M, 3 * C, C,
                   0};
  p1.outf = hf;
  igemm::launch_conv<igemm::kDense>(p1, dense, s);

  launch_fat_rows(static_cast<const float*>(hf), g2, b2, fb, T, S, C, M, s);
  const igemm::Params p2{fb, static_cast<const __nv_bfloat16*>(w2),
                         static_cast<const float*>(bias2), nullptr, xb,
                         static_cast<__nv_bfloat16*>(out), M, 3 * C, C, 0};
  igemm::launch_conv<igemm::kDense>(p2, dense, s);
  return (int)cudaGetLastError();
}
