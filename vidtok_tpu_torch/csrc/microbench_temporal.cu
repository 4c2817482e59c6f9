// The temporal-resblock microbenchmark's kernels T1-T3, the counterparts of
// the Pallas kernels of the JAX package's tools/microbench_temporal.py, over
// x [B, T, S = H*W, C] bf16.
//
// T3 replaces :130 copy_min (pallas_call at :140), the TPU's copy floor:
// out = x, one unit at a time, a unit being tile_t frames x tile_s positions
// x C channels, i.e. tile_t runs of tile_s * C contiguous values, one per
// frame. Bound: bytes, 2 |x| (x read and out written once) over 3.35 TB/s.
// Design: Hopper's bulk async copies (the TMA's 1-D form). Each run is cut
// into pieces of up to 32 KB; one 32-thread block a piece, numbered unit by
// unit and frame by frame in the TPU grid's order, whose one thread loads
// the piece into shared memory (cp.async.bulk ... mbarrier::complete_tx),
// waits on the mbarrier and writes it back (cp.async.bulk ... bulk_group).
// No registers hold data and no thread computes per-element addresses (the
// 64-bit divisions run once a piece); a block takes 33 KB of shared memory
// with its reserve, so six pieces are in flight on each SM; a small tile_s gives more,
// shorter pieces, never half-empty blocks. A persistent grid (one or two
// blocks per SM, each walking an equal contiguous share through a ring of
// 3-12 stages) was slower at every tiling: 132 streams far apart in memory
// read worse than blocks issued in order (PERF.md, Findings). The tiling
// orders the work only: the card has no per-step VMEM buffer to size.
//
// T2 replaces :102 fused_diag (pallas_call at :111, body :81), in three
// modes:
//   copy: out = x, T3's bulk copy with one unit per clip;
//   mm:   h = bf16(conv1_t(x)), out = bf16(x + conv2_t(h)), the two causal
//         k=3 time convs with a zero front, no bias and no LN: kernel B's
//         own GEMM loop (wgmma_conv.cuh, launched with
//         plan.conv_plan_temporal's plan and B's weight maps) with the tap
//         set kCausal, which reads x itself through a 3-D map {C, T*S, B}
//         and takes tap k of row r from row r + (k - 2) * S: TMA's zero
//         fill below row 0 of each clip is the zero front. So neither x
//         nor h is copied behind a front (B's scratch pass would cost 2|x|
//         bytes, ~0.02 ms at [1,9,64^2,512] and ~0.2 ms at [1,20,256^2,128]),
//         M tiles that straddle frames (S % 128 != 0) read each row from its
//         own frame, and no tap crosses a clip. conv1's epilogue writes h
//         (bf16, no bias: the loop takes a null bias) and conv2's adds x.
//         Bound: operations at C = 512 (12 C^2 FLOP per position), bytes
//         at 128, as B's products;
//   ln:   a1 = bf16(ln_silu(x; norm1)), a2 = bf16(ln_silu(a1; norm2)),
//         out = bf16(x + a2), the exact LN+SiLU, in registers in one pass
//         over x (ln_twice_kernel). Bound: bytes.
//
// T1 replaces :53 fused_fat (pallas_call at :62): kernel B in zero mode with
// the exact LN+SiLU, the three time taps of each conv concatenated into one
// [M, 3C] x [3C, C] product. Bound: operations at C = 512, as B's; its own
// explicit operand makes it byte-bound at 128. Design: the TPU's question,
// one fat product or three accumulated taps, asked of the loop kernel B
// runs. A row pass (fat_rows_kernel) writes each activated row into its
// three places of the fat operand [a(t-2) | a(t-1) | a(t)] (zeros before
// frame 0 of each clip; a [M, 3C] bf16 scratch); the wgmma loop with the
// tap set kDense (one tap, a 2-D map over the operand, K = 3C in 64-channel
// steps, plan.conv_plan_dense) adds the bias and writes h in f32, because
// the TPU kernel's second LN reads h unrounded; the row pass again, from h;
// the dense product adds the bias and x. Kernel B gives the other answer:
// implicit taps, nothing materialised beyond its activated scratch.
//
// The row passes: act_rows_kernel's layout (common.cuh, VT_ROW_LAYOUTS): a
// row takes LPR lanes (8 to 32), a warp 32 / LPR rows, each thread loads
// its RPT rows before it reduces any, the vectors from channel C on masked;
// the statistics are the exact two-pass form (row_stats_exact) over the
// row's LPR lanes; g and b are read as vectors, once per vector slot for
// all of a thread's rows. C % 8 == 0 up to 1024 (plan.row_layout), else
// cudaErrorInvalidValue.
#include <stdint.h>
#include <string.h>

#include "wgmma_conv.cuh"

namespace {

constexpr int kCopyPiece = 32 * 1024;  // bytes of one bulk copy, one block

// The runs of a [B, T, S, C] bf16 tensor in unit order: run r is frame
// r % tile_t of unit r / tile_t, unit = (b, t // tile_t, s // tile_s) with
// the last fastest; each run is ``run`` bytes, ``pieces`` pieces.
struct CopyRuns {
  int T, S, tile_t, tile_s, nt, ns;
  long long row;     // bytes per position, 2 C
  long long run;     // bytes per run, tile_s * row
  long long pieces;  // pieces per run
};

// Byte offset of run r in x (and in out).
__device__ __forceinline__ long long run_offset(const CopyRuns& w, long long r) {
  const int f = (int)(r % w.tile_t);
  const long long unit = r / w.tile_t;
  const int ks = (int)(unit % w.ns);
  const long long rest = unit / w.ns;
  const int kt = (int)(rest % w.nt);
  const long long b = rest / w.nt;
  return ((b * w.T + (long long)kt * w.tile_t + f) * w.S + (long long)ks * w.tile_s) * w.row;
}

// out = x over piece blockIdx.x: piece blockIdx.x % pieces of run
// blockIdx.x / pieces.
__global__ void __launch_bounds__(32) copy_bulk_kernel(const char* __restrict__ x,
                                                       char* __restrict__ out, CopyRuns w) {
  using namespace vt::wg;
  extern __shared__ __align__(128) unsigned char piece[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const long long r = blockIdx.x / w.pieces, j = blockIdx.x - r * w.pieces;
  const long long off = run_offset(w, r) + j * kCopyPiece;
  const long long left = w.run - j * kCopyPiece;
  const int len = left < kCopyPiece ? (int)left : kCopyPiece;
  const uint32_t dst = smem_u32(piece), b = smem_u32(&bar);
  mbar_init(b, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  mbar_expect_tx(b, len);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(x + off)), "r"(len), "r"(b)
      : "memory");
  mbar_wait(b, 0);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(out + off)),
               "r"(dst), "r"(len)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  // the piece's shared memory stays the block's until the store has read it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// T3 over a [B, T, S, C] bf16 tensor; cudaErrorInvalidValue unless x and out
// are 16-byte aligned and C % 8 == 0 (every run and piece is then a multiple
// of 16 B, as bulk copies need).
int launch_copy(const void* x, void* out, int B, int T, int S, int C, int tile_t,
                int tile_s, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 || C % 8 ||
      tile_t <= 0 || tile_s <= 0 || T % tile_t || S % tile_s)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      copy_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCopyPiece);
  if (e != cudaSuccess) return (int)e;
  const long long run = 2LL * C * tile_s;
  const CopyRuns w{T, S, tile_t, tile_s, T / tile_t, S / tile_s, 2LL * C, run,
                   (run + kCopyPiece - 1) / kCopyPiece};
  const long long blocks = (long long)B * T * (S / tile_s) * w.pieces;
  copy_bulk_kernel<<<(unsigned)blocks, 32, kCopyPiece, s>>>(static_cast<const char*>(x),
                                                            static_cast<char*>(out), w);
  return (int)cudaGetLastError();
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

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16(f));
}

// First row of this thread (rows of a warp: 32 / LPR at a time, RPT times).
template <int LPR, int RPT>
__device__ __forceinline__ long long first_row(int lane) {
  return ((long long)blockIdx.x * 8 + (threadIdx.x >> 5)) * ((32 / LPR) * RPT) + lane / LPR;
}

// The RPT rows of C channels of this thread, rows past ``rows`` and
// vectors past C as zeros (they take part in the shuffles and are not
// stored).
template <int LPR, int VPL, int RPT, typename In>
__device__ __forceinline__ void load_rows(const In* __restrict__ src, long long row0,
                                          long long rows, int l, int C,
                                          float (&v)[RPT][VPL][8]) {
  constexpr int RPW = 32 / LPR;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long row = row0 + (long long)k * RPW;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (row < rows && vt::row_vec<LPR>(l, i, C)) {
        load8(src + row * C + 8 * l + 8 * LPR * i, v[k][i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][i][e] = 0.f;
      }
    }
  }
}

// g and b of channels c .. c + 7, as vectors.
__device__ __forceinline__ void load_gb(const float* g, const float* b, int c, float* gv,
                                        float* bv) {
  load8(g + c, gv);
  load8(b + c, bv);
}

// For row = (clip, t, s) of src [B, T, S, C] (bf16 x, or f32 h): a =
// bf16(ln_silu_exact_f32(src[row])) is written to the fat operand fat
// [B*T*S, 3C] in column block 2 of row (clip, t, s), block 1 of (clip, t+1,
// s) and block 0 of (clip, t+2, s), where those frames exist; the blocks of
// frames 0 and 1 that no frame fills (taps before frame 0) are zeroed.
template <int LPR, int VPL, int RPT, typename In>
static __global__ void __launch_bounds__(256)
    fat_rows_kernel(const In* __restrict__ src, const float* __restrict__ g,
                    const float* __restrict__ b, __nv_bfloat16* __restrict__ fat, int T,
                    int S, int C, long long rows) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const long long row0 = first_row<LPR, RPT>(lane);
  float v[RPT][VPL][8];
  load_rows<LPR, VPL, RPT>(src, row0, rows, l, C, v);
  // the frame of each row: that of the first (one division), then stepped
  // RPW rows at a time
  int fr[RPT];
  {
    const long long q = row0 / S;
    int pos = (int)(row0 - q * S), f = (int)(q % T);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (k > 0)
        for (pos += RPW; pos >= S; pos -= S)
          if (++f == T) f = 0;
      fr[k] = f;
    }
  }
  float2 st[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) st[k] = vt::row_stats_exact<LPR, VPL>(v[k], C, l);
  const long long ld = 3LL * C, next = (long long)S * ld;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 8 * l + 8 * LPR * i;
    if (c >= C) continue;
    float gv[8], bv[8];
    load_gb(g, b, c, gv, bv);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const long long row = row0 + (long long)k * RPW;
      if (row >= rows) continue;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = vt::ln_silu_exact_f32(v[k][i][e], st[k].x, st[k].y, gv[e], bv[e]);
      const uint4 a = vt::pack8(f);
      __nv_bfloat16* p = fat + row * ld + c;
      *reinterpret_cast<uint4*>(p + 2 * C) = a;
      if (fr[k] + 1 < T) *reinterpret_cast<uint4*>(p + next + C) = a;
      if (fr[k] + 2 < T) *reinterpret_cast<uint4*>(p + 2 * next) = a;
      if (fr[k] < 2) *reinterpret_cast<uint4*>(p) = zero;
      if (fr[k] < 1) *reinterpret_cast<uint4*>(p + C) = zero;
    }
  }
}

template <typename In>
int launch_fat_rows(const In* src, const void* g, const void* b, __nv_bfloat16* fat, int T,
                    int S, int C, long long rows, cudaStream_t s) {
  const auto* gf = static_cast<const float*>(g);
  const auto* bf = static_cast<const float*>(b);
#define VT_FAT_ROWS(L, V, R)                                                              \
  {                                                                                       \
    const long long per = 8LL * (32 / L) * R;                                             \
    fat_rows_kernel<L, V, R, In><<<(unsigned)((rows + per - 1) / per), 256, 0, s>>>(     \
        src, gf, bf, fat, T, S, C, rows);                                                 \
    return (int)cudaGetLastError();                                                       \
  }
  VT_ROW_LAYOUTS(C, VT_FAT_ROWS)
#undef VT_FAT_ROWS
  return (int)cudaErrorInvalidValue;
}

// out[row] = bf16(x + a2), a2 = bf16(ln_silu_exact_f32(a1; g2, b2)),
// a1 = bf16(ln_silu_exact_f32(x; g1, b1)), in registers: x as f32, a1 as
// the bf16 it is rounded to (half the registers, nothing lost). Three
// blocks an SM (at most 80 registers a thread, a few bytes spilled to L1)
// ran about 5% faster than two without spills; holding x packed as well
// gained nothing more. The pass's exp and division (two SFU operations a
// value each LN) take about as long as its bytes, so it sits between
// the two bounds. FULL: C = 8 LPR VPL (no masked vector), a constant, so
// the masks and C's register go.
template <int LPR, int VPL, int RPT, bool FULL>
static __global__ void __launch_bounds__(256, 3)
    ln_twice_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g1,
                    const float* __restrict__ b1, const float* __restrict__ g2,
                    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int c_arg,
                    long long rows) {
  constexpr int RPW = 32 / LPR;
  const int C = FULL ? 8 * LPR * VPL : c_arg;
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const long long row0 = first_row<LPR, RPT>(lane);
  float v[RPT][VPL][8];
  uint4 a[RPT][VPL];
  load_rows<LPR, VPL, RPT>(x, row0, rows, l, C, v);
  float2 st[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) st[k] = vt::row_stats_exact<LPR, VPL>(v[k], C, l);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    float gv[8], bv[8];
    if (vt::row_vec<LPR>(l, i, C)) {
      load_gb(g1, b1, 8 * l + 8 * LPR * i, gv, bv);
    } else {  // a masked vector activates to zeros, which the second LN leaves out
#pragma unroll
      for (int e = 0; e < 8; ++e) gv[e] = bv[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = vt::ln_silu_exact_f32(v[k][i][e], st[k].x, st[k].y, gv[e], bv[e]);
      a[k][i] = vt::pack8(f);
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float f[VPL][8];
#pragma unroll
    for (int i = 0; i < VPL; ++i) vt::unpack8(a[k][i], f[i]);
    st[k] = vt::row_stats_exact<LPR, VPL>(f, C, l);
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 8 * l + 8 * LPR * i;
    if (c >= C) continue;
    float gv[8], bv[8];
    load_gb(g2, b2, c, gv, bv);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const long long row = row0 + (long long)k * RPW;
      if (row >= rows) continue;
      float f[8];
      vt::unpack8(a[k][i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = v[k][i][e] + round_bf16(vt::ln_silu_exact_f32(f[e], st[k].x, st[k].y, gv[e], bv[e]));
      *reinterpret_cast<uint4*>(out + row * C + c) = vt::pack8(f);
    }
  }
}

int launch_ln_twice(const __nv_bfloat16* x, const float* g1, const float* b1,
                    const float* g2, const float* b2, __nv_bfloat16* out, int C,
                    long long rows, cudaStream_t s) {
#define VT_LN_TWICE(L, V, R)                                                              \
  {                                                                                       \
    const long long per = 8LL * (32 / L) * R;                                             \
    const unsigned grid = (unsigned)((rows + per - 1) / per);                             \
    if (C == 8 * L * V)                                                                   \
      ln_twice_kernel<L, V, R, true><<<grid, 256, 0, s>>>(x, g1, b1, g2, b2, out, C, rows); \
    else                                                                                  \
      ln_twice_kernel<L, V, R, false><<<grid, 256, 0, s>>>(x, g1, b1, g2, b2, out, C, rows); \
    return (int)cudaGetLastError();                                                       \
  }
  VT_ROW_LAYOUTS(C, VT_LN_TWICE)
#undef VT_LN_TWICE
  return (int)cudaErrorInvalidValue;
}

// The wgmma loop's parameters of a C -> C product of three taps of C
// channels, ceil(C / 64) K steps a tap: a kCausal conv over B clips of T
// frames of S rows, or a kDense product over M = S rows (B = T = 1) of the
// fat operand, tap k its columns [kC, (k + 1) C).
vt::wg::Params loop_params(int B, int T, int S, int C, int bn, int stages) {
  vt::wg::Params p{};
  p.T = T;
  p.S = S;
  p.tiles_x = (int)(((long long)T * S + vt::wg::BM - 1) / vt::wg::BM);
  p.m_tiles = B * p.tiles_x;
  p.par_tiles = p.n_tiles = (C + bn - 1) / bn;
  p.Cout = p.Cin = C;
  p.cin_steps = (C + vt::wg::BK - 1) / vt::wg::BK;
  p.k_main = p.k_total = 3 * p.cin_steps;
  p.stages = stages;
  return p;
}

}  // namespace

// T3: C % 8 == 0, tile_t | T, tile_s | S, x and out 16-byte aligned.
extern "C" int vt_copy_units(const void* x, void* out, int B, int T, int S, int C,
                             int tile_t, int tile_s, void* stream) {
  return launch_copy(x, out, B, T, S, C, tile_t, tile_s, static_cast<cudaStream_t>(stream));
}

// T2: mode 0 copy, 1 mm, 2 ln. mm: h a [B, T, S, C] bf16 scratch, w1map and
// w2map the K-major [C, 3C] weights' tensor maps, (bn, stages, smem, grid)
// plan.conv_plan_temporal's plan; ln: C % 8 == 0 up to 1024.
extern "C" int vt_microbench_diag(const void* x, void* out, void* h, const void* g1,
                                  const void* b1, const void* w1map, const void* g2,
                                  const void* b2, const void* w2map, int B, int T, int S,
                                  int C, int mode, int bn, int stages, int smem, int grid,
                                  void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (mode == 0) return launch_copy(x, out, B, T, S, C, T, S, s);
  if (mode == 2)
    return launch_ln_twice(xb, static_cast<const float*>(g1), static_cast<const float*>(b1),
                           static_cast<const float*>(g2), static_cast<const float*>(b2), ob,
                           C, M, s);
  CUtensorMap mx, mh, mw1, mw2, unused;
  wg::read_weight_maps(w1map, &mw1, &unused);
  wg::read_weight_maps(w2map, &mw2, &unused);
  int e = wg::temporal_map(&mx, x, B, (long long)T * S, C);
  if (e || (e = wg::temporal_map(&mh, h, B, (long long)T * S, C))) return e;
  wg::Params p = loop_params(B, T, S, C, bn, stages);
  p.out = static_cast<__nv_bfloat16*>(h);  // no bias
  if ((e = wg::launch_conv<wg::kCausal>(mx, mw1, mx, mw1, p, bn, smem, grid, s))) return e;
  p.res = xb;
  p.out = ob;
  return wg::launch_conv<wg::kCausal>(mh, mw2, mh, mw2, p, bn, smem, grid, s);
}

// T1: C % 8 == 0 up to 1024; fat a [B*T*S, 3C] bf16 scratch, h a
// [B*T*S, C] f32 scratch; w1map, w2map the K-major [C, 3C] weights' tensor
// maps, (bn, stages, smem, grid) plan.conv_plan_dense's plan.
extern "C" int vt_microbench_fat(const void* x, void* out, void* fat, void* h,
                                 const void* g1, const void* b1, const void* w1map,
                                 const void* bias1, const void* g2, const void* b2,
                                 const void* w2map, const void* bias2, int B, int T, int S,
                                 int C, int bn, int stages, int smem, int grid, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  if (M > 0x7fffffffLL - wg::BM) return wg::kErrPlan;  // TMA's row coordinate
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* fb = static_cast<__nv_bfloat16*>(fat);
  auto* hf = static_cast<float*>(h);
  CUtensorMap ma, mw1, mw2, unused;
  wg::read_weight_maps(w1map, &mw1, &unused);
  wg::read_weight_maps(w2map, &mw2, &unused);
  int e = wg::matrix_map(&ma, fat, 3 * C, (int)M);  // [M, 3C], K-major
  if (e) return e;
  wg::Params p = loop_params(1, 1, (int)M, C, bn, stages);

  if ((e = launch_fat_rows(xb, g1, b1, fb, T, S, C, M, s))) return e;
  p.bias = static_cast<const float*>(bias1);
  p.outf = hf;
  if ((e = wg::launch_conv<wg::kDense>(ma, mw1, ma, mw1, p, bn, smem, grid, s))) return e;

  if ((e = launch_fat_rows(static_cast<const float*>(hf), g2, b2, fb, T, S, C, M, s))) return e;
  p.bias = static_cast<const float*>(bias2);
  p.outf = nullptr;
  p.res = xb;
  p.out = static_cast<__nv_bfloat16*>(out);
  return wg::launch_conv<wg::kDense>(ma, mw2, ma, mw2, p, bn, smem, grid, s);
}
