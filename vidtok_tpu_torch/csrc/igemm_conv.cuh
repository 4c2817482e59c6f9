// Implicit-GEMM conv over channels-last rows on the wmma loop, used only by
// the temporal microbenchmark's kernels T1 and T2 (microbench_temporal.cu:
// kTemporal, B's k=3 causal taps in zero mode, and kDense, one tap where row
// m reads a[m]); no serving path runs it. The serving kernels (A, B, E, F)
// run the warp-specialised TMA + wgmma loop of wgmma_conv.cuh.
//
//   out[m, n] = bf16( bias[n] + res[m, n]
//                     + sum_{tap, c} a[src(m, tap), c] * w[tap*Cin + c, n]
//                     + sum_{c < Cs} xs[m, c] * w[taps*Cin + c, n] )
//
// M = positions, N = Cout, K = taps x Cin (+ Cs channels of an extra 1x1
// term over other rows). ``a`` is the ALREADY activated tensor, so a tap
// before frame 0 reads zero: the conv's zero-mode padding after the
// activation. kDense may write bias + acc in f32 to ``outf`` instead of
// bf16 to ``out``.
//
// Tiling: a 128 x 128 output tile per 128-thread block; K in steps of 32
// channels of one tap. Each step's A tile (gathered rows, zero-filled when
// the tap is padding) and B tile (weights) are copied to shared memory by
// cp.async in a 3-stage ring, so two steps' copies are in flight while 4
// warps run bf16 wmma 16x16x16 products into f32 accumulators (64 x 64 per
// warp). One barrier per step. Requires Cin % 32, Cs % 32 and Cout % 128
// to be 0. Measured on the H100 against other shapes of this loop: 32 x 64
// warp tiles (8 warps) 5% slower, K steps of 64 4% slower, a 4-stage ring
// no faster, 256-row blocks 16% slower.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vt {
namespace igemm {

// tap sets: causal k=3 temporal, one tap (a dense product)
enum Taps { kTemporal = 1, kDense = 3 };

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int WGM = 2, WGN = 2, kMinBlocks = 2;  // warp grid: 64 x 64 tiles
constexpr int kThreads = 32 * WGM * WGN;
constexpr int FM = BM / WGM / 16, FN = BN / WGN / 16;  // fragments per warp
constexpr int TPR = kThreads / BM;         // copier threads per A row
constexpr int A_LD = BK + 8;  // bf16 per staged A row (80 B: 16 B aligned)
constexpr int B_LD = BN + 8;
constexpr int kStageElems = BM * A_LD + BK * B_LD;
constexpr int kSmemBytes = STAGES * kStageElems * 2;

struct Geometry {
  int T, S;  // temporal: clips of T frames of S positions, taps t-2..t
};

struct Params {
  const __nv_bfloat16* a;    // [M, Cin] activated rows
  const __nv_bfloat16* w;    // [taps * Cin + Cs, Cout]
  const float* bias;         // [Cout]
  const __nv_bfloat16* xs;   // [M, Cs] rows of the 1x1 term, or null
  const __nv_bfloat16* res;  // [M, Cout] residual, or null
  __nv_bfloat16* out;        // [M, Cout]
  long long M;
  int Cin, Cout, Cs;
  float* outf;               // kDense: [M, Cout] f32 in place of out, or null
};

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int TAPS>
static __global__ void __launch_bounds__(kThreads, kMinBlocks)
    conv_kernel(const Params p, const Geometry g) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A copier: BK/TPR channels from column ac of tile row ar; the row's
  // position is decomposed once.
  const int ar = tid / TPR, ac = (tid % TPR) * (BK / TPR);
  const long long am = m0 + ar;
  const bool arow = am < p.M;
  long long base = 0;
  int pa = 0;  // temporal: frame within the clip
  if (arow && TAPS != kDense) {
    const long long ts = (long long)g.T * g.S;
    const long long b = am / ts;
    const long long r = am - b * ts;
    pa = (int)(r / g.S);
    base = b * ts + (r - (long long)pa * g.S);
  }
  // B copier: 8 columns from bc of rows br, br + kThreads/16, ...
  const int br = tid / (BN / 8), bc = (tid % (BN / 8)) * 8;
  constexpr int kBRowStep = kThreads / (BN / 8);

  constexpr int kTaps = TAPS == kTemporal ? 3 : 1;
  const int kmain = kTaps * p.Cin;
  const int nk = (kmain + p.Cs) / BK;

  auto load = [&](int kb, int stage) {
    __nv_bfloat16* As = smem + stage * kStageElems;
    __nv_bfloat16* Bs = As + BM * A_LD;
    const int k0 = kb * BK;
    const __nv_bfloat16* src = p.a;  // any valid address when zero-filling
    bool valid = false;
    if (k0 < kmain) {
      const int tap = k0 / p.Cin;
      const int c = k0 - tap * p.Cin + ac;
      long long row = -1;
      if (arow && TAPS == kDense) {
        row = am;
      } else if (arow) {
        const int sf = pa + tap - 2;
        if (sf >= 0) row = base + (long long)sf * g.S;
      }
      valid = row >= 0;
      if (valid) src = p.a + row * p.Cin + c;
    } else if (arow) {
      valid = true;
      src = p.xs + am * p.Cs + (k0 - kmain) + ac;
    }
#pragma unroll
    for (int i = 0; i < BK / TPR / 8; ++i)
      cp_async16(As + ar * A_LD + ac + 8 * i, valid ? src + 8 * i : src, valid);
    const __nv_bfloat16* wq = p.w + (long long)(k0 + br) * p.Cout + n0 + bc;
#pragma unroll
    for (int i = 0; i < BK / kBRowStep; ++i)
      cp_async16(Bs + (br + kBRowStep * i) * B_LD + bc,
                 wq + (long long)kBRowStep * i * p.Cout, true);
  };

  const int wm = warp / WGN, wn = warp % WGN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<STAGES - 2>();  // step kb's copies have landed
    __syncthreads();              // ... for every thread; stage kb-1 is free
    const int next = kb + STAGES - 1;
    if (next < nk) load(next, next % STAGES);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kb % STAGES) * kStageElems;
    const __nv_bfloat16* Bs = As + BM * A_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * FM + i) * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + (wn * FN + j) * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue

  // epilogue through a per-warp 16 x 16 f32 scratch: bias, residual, bf16
  float* ep = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(ep, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + (wm * FM + i) * 16 + er;
      const int n = n0 + (wn * FN + j) * 16 + ec;
      if (m < p.M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = ep[er * 16 + ec + e] + p.bias[n + e];
        if (TAPS == kDense && p.outf != nullptr) {
          float4* d = reinterpret_cast<float4*>(p.outf + m * p.Cout + n);
          d[0] = make_float4(v[0], v[1], v[2], v[3]);
          d[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          __nv_bfloat16* dst = p.out + m * p.Cout + n;
          if (p.res != nullptr) {
            float r[8];
            unpack8(ld_u4(p.res + m * p.Cout + n), r);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += r[e];
          }
          *reinterpret_cast<uint4*>(dst) = pack8(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int TAPS>
static inline void launch_conv(const Params& p, const Geometry& g, cudaStream_t s) {
  cudaFuncSetAttribute(conv_kernel<TAPS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)(p.Cout / BN));
  conv_kernel<TAPS><<<grid, kThreads, kSmemBytes, s>>>(p, g);
}

}  // namespace igemm
}  // namespace vt
