// Implicit-GEMM conv for Hopper: a warp-specialised ring of TMA loads
// feeding wgmma, used by kernel A (3x3 spatial taps, fused_spatial.cu),
// kernels B and F (k=3 temporal taps over a scratch with a 2-frame front,
// temporal_block.cuh) and kernel E (2 frames x 3x3 taps, parity_upsample.cu):
//
//   out[m, n] = bf16( bias[n] + res[m, n]
//                     + sum_{tap, c} a[src(m, tap), c] * w[n, tap*Cin + c]
//                     + sum_{c < Cs} xs[m, c] * w[n, taps*Cin + c] )
//
// M = positions, N = Cout, K = taps x Cin (+ Cs channels of a 1x1 term over
// the raw input, the nin_shortcut). ``a`` is the ALREADY activated bf16
// scratch (act_rows_kernel, common.cuh). w is K-major, [Cout, K].
//
// Tap sets. kSpatial: ``a`` is [N, H, W, Cin], a 4-D tensor map {C, W, H,
// N}; an M tile is a th x tw patch of one frame (th * tw = 128) and tap
// (dy, dx) is the same box loaded at (c0, x0 + dx - 1, y0 + dy - 1, n).
// TMA fills elements outside the frame with zeros, so the SAME padding is
// a true zero after LayerNorm+SiLU with no index arithmetic per row. The
// 1x1 term is a second 4-D map over the raw input, unshifted.
// kTemporal: ``a`` is [B, (T + 2) * S, Cin], a 3-D map, clips holding two
// frames before each output frame (F's cache, or B's stream-start front);
// an M tile is 128 consecutive rows of one clip and tap k is the same box
// k*S rows on, so every tap reads a real frame. Rows past a clip's end read
// zeros; their outputs are not stored.
// kParity (kernel E): ``a`` is the raw input s [B, T, H, W, C], a 5-D map
// {C, W, H, T, B}; an M tile is a th x tw patch of frame t of clip b, and
// tap (f, dy, dx), f = 0 for frame t-1 and 1 for frame t, is the box at
// (c0, x0 + dx - 1, y0 + dy - 1, t - 1 + f, b). TMA's zero fill is the
// spatial SAME padding (exact: s is not activated) and, at t = 0, the
// zero-mode front: t = -1 lies outside the clip, so no tap ever reads the
// previous clip. Replicate mode clamps that frame to 0. N = 2C columns are
// the even and odd output frames; the epilogue blends them with s:
//   out[2 img + p, y, x, c] = bf16( alpha * s[img, y, x, c]
//                                   + (1 - alpha) * (acc[m, pC + c] + bias[pC + c]) )
// for img = b*T + t. BN divides C, so an N tile is one parity's.
//
// Shape of the loop (warp-specialised, as CUTLASS's Hopper GEMMs): two
// consumer warpgroups and a producer, one thread of which issues, for each
// K step of 64 channels, the A box (128 rows x 128 B) and the weight box
// (BN rows x 128 B), both with 128-byte swizzle, into a ring of ``stages``
// stages guarded by full and empty mbarriers. The consumers each run wgmma
// m64nBNk16 on their 64 rows of the stage, the f32 accumulators in
// registers, one wgmma group in flight while the next stage is awaited.
// The epilogue goes
// through the (then idle) ring: accumulators to an f32 tile in shared
// memory, then whole rows with the bias and the residual added, rounded to
// bf16, in 16-byte stores; positions outside the frame or past the clip
// are not stored (kParity: written to the parity's frame). Offsets that
// can pass 2^31 are 64-bit.
//
// The plan (patch, BN in {128, 256}, stages, shared memory, grid) comes
// from ops/kernels/plan.py, which the CPU tests check; launch_conv refuses
// what it cannot run. BN = 256 runs one block of 384 threads per SM (4
// stages, 197,696 B of shared memory): the producer is a warpgroup that
// gives its registers up to the consumers' 128 accumulators (setmaxnreg 40
// and 232). BN = 128 runs two blocks of 288 threads per SM (3 stages,
// 99,376 B each; the producer one warp, every thread at most 112
// registers), so one block's epilogue and ring fill overlap the other's
// products. (Two blocks of 384 threads leave 80 registers a thread at
// compile time, too few for wgmma m64n128's 64 accumulators.)
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <string.h>

#include "common.cuh"

namespace vt {
namespace wg {

enum Taps { kSpatial = 0, kTemporal = 1, kParity = 2 };

constexpr int BM = 128, BK = 64;
constexpr int kConsumers = 2;
constexpr int kTileA = BM * BK * 2;  // bytes of one A stage
constexpr int kErrNoEncoder = 1001, kErrEncode = 1002, kErrPlan = 1003;

__host__ __device__ constexpr int stage_bytes(int bn) { return kTileA + bn * BK * 2; }

struct Params {
  const float* bias;         // [Cout]
  const __nv_bfloat16* res;  // [M, Cout] residual, or null; kParity: s [M, Cout / 2]
  __nv_bfloat16* out;        // [M, Cout]; kParity: [2M, Cout / 2]
  const float* alpha;        // kParity: the blend weight
  int H, W;                  // kSpatial, kParity: the frame
  int T, S;                  // kTemporal: output frames per clip, rows per frame;
                             // kParity: T frames per clip
  int replicate;             // kParity: the front at t = 0 is frame 0 (else zeros)
  int th, tw;                // kSpatial, kParity: the patch of an M tile
  int tiles_x, tiles_y;      // kSpatial, kParity: patches per frame row / column;
                             // kTemporal: tiles_x = M tiles per clip
  int n_tiles;               // Cout / BN
  int Cout;
  int cin_steps;             // Cin / BK: K steps per tap
  int k_main, k_total;       // K steps of the taps; with the 1x1 term
  int stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma operand descriptor of a K-major tile in shared memory with 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (the tile 1024-aligned).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D[64 x 128] += A[64 x 16] B[16 x 128], both K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], both K-major in shared memory.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_n256(d, da, db);
  } else {
    static_assert(BN == 128, "BN is 128 or 256");
    wgmma_n128(d, da, db);
  }
}

// threads of a block (the consumers, then a producer warpgroup or warp)
// and blocks per SM
template <int BN> constexpr int kThreads = 128 * kConsumers + (BN == 256 ? 128 : 32);
template <int BN> constexpr int kBlocksPerSM = BN == 128 ? 2 : 1;

template <int TAPS, int BN>
static __global__ void __launch_bounds__(kThreads<BN>, kBlocksPerSM<BN>)
    conv_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  unsigned char* smem = smem_raw + (base - raw);
  constexpr int kStage = stage_bytes(BN);
  const uint32_t full = base + p.stages * kStage;  // full[s] = full + 8s
  const uint32_t empty = full + 8 * p.stages;      // empty[s] = empty + 8s

  // this block's tile: N tiles of one M tile are neighbours in launch order
  const int n0 = (blockIdx.x % p.n_tiles) * BN;
  const int mt = blockIdx.x / p.n_tiles;
  int x0 = 0, y0 = 0, img = 0;  // kSpatial, kParity: patch origin and frame
  int r0 = 0, clip = 0;         // kTemporal: first row within the clip; clip
  int t = 0;                    // kParity: frame within the clip
  if (TAPS != kTemporal) {
    const int q = mt / p.tiles_x;
    x0 = (mt - q * p.tiles_x) * p.tw;
    img = q / p.tiles_y;
    y0 = (q - img * p.tiles_y) * p.th;
    if (TAPS == kParity) {
      clip = img / p.T;
      t = img - clip * p.T;
    }
  } else {
    clip = mt / p.tiles_x;
    r0 = (mt - clip * p.tiles_x) * BM;
  }

  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every load
    if constexpr (BN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      prefetch_map(&map_a);
      prefetch_map(&map_w);
      if (p.k_total > p.k_main) prefetch_map(&map_x);
      int s = 0, phase = 0;
      for (int ks = 0; ks < p.k_total; ++ks) {
        mbar_wait(empty + 8 * s, phase ^ 1);  // the first round passes
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, kStage);
        const uint32_t dst = base + s * kStage;
        if (ks < p.k_main) {
          const int tap = ks / p.cin_steps;
          const int c = (ks - tap * p.cin_steps) * BK;
          if (TAPS == kSpatial) {
            tma_4d(dst, &map_a, bar, c, x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);
          } else if (TAPS == kParity) {
            const int st = tap % 9;
            int f = t - 1 + tap / 9;  // taps 0-8 frame t-1, 9-17 frame t
            if (f < 0 && p.replicate) f = 0;
            tma_5d(dst, &map_a, bar, c, x0 + st % 3 - 1, y0 + st / 3 - 1, f, clip);
          } else {
            tma_3d(dst, &map_a, bar, c, r0 + tap * p.S, clip);
          }
        } else {
          tma_4d(dst, &map_x, bar, (ks - p.k_main) * BK, x0, y0, img);
        }
        tma_2d(dst + kTileA, &map_w, bar, ks * BK, n0);
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if constexpr (BN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int lane = threadIdx.x & 31;
    int s = 0, phase = 0, prev = -1;
    for (int ks = 0; ks < p.k_total; ++ks) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t a = base + s * kStage + wg * (64 * 128);  // this warpgroup's rows
      const uint32_t w = base + s * kStage + kTileA;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_k16<BN>(acc, smem_desc(a + 32 * k), smem_desc(w + 32 * k));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with its stage
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    named_sync(1, 128 * kConsumers);  // both warpgroups are done with the ring

    // accumulators -> f32 tile [BM][BN + 8] over the ring (the padding
    // spreads a warp's 8 rows over the banks)
    constexpr int LD = BN + 8;
    float* tile = reinterpret_cast<float*>(smem);
    const int tid = threadIdx.x & 127;
    const int row = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    const int cq = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(tile + row * LD + 8 * j + cq) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile + (row + 8) * LD + 8 * j + cq) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_sync(2 + wg, 128);  // this warpgroup's 64 rows are in place

    // whole rows: 8 columns a thread, bias and residual (or blend) in f32,
    // bf16 out
    constexpr int TPR = BN / 8, RPP = 128 / TPR;
    const int col = (tid % TPR) * 8;
    float bias[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) bias[e] = p.bias[n0 + col + e];
    // kParity: this N tile's parity and channels, and the blend weight
    const int half = p.Cout / 2, par = n0 >= half, c0 = n0 - par * half + col;
    const float alpha = TAPS == kParity ? *p.alpha : 0.f;
    for (int r = wg * 64 + tid / TPR; r < wg * 64 + 64; r += RPP) {
      long long m;
      if (TAPS != kTemporal) {
        const int y = y0 + r / p.tw, x = x0 + r % p.tw;
        if (y >= p.H || x >= p.W) continue;
        m = ((long long)img * p.H + y) * p.W + x;
      } else {
        const long long rr = r0 + r;
        if (rr >= (long long)p.T * p.S) continue;
        m = (long long)clip * p.T * p.S + rr;
      }
      const float4 lo = *reinterpret_cast<const float4*>(tile + r * LD + col);
      const float4 hi = *reinterpret_cast<const float4*>(tile + r * LD + col + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += bias[e];
      if (TAPS == kParity) {
        // s row m, then output frame 2 img + par at the same position
        float sv[8];
        unpack8(ld_u4(p.res + m * half + c0), sv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = alpha * sv[e] + (1.f - alpha) * v[e];
        const long long hw = (long long)p.H * p.W;
        const long long off = ((2 * img + par) * hw + (m - img * hw)) * half + c0;
        *reinterpret_cast<uint4*>(p.out + off) = pack8(v);
        continue;
      }
      const long long off = m * p.Cout + n0 + col;
      if (p.res != nullptr) {
        float rv[8];
        unpack8(ld_u4(p.res + off), rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += rv[e];
      }
      *reinterpret_cast<uint4*>(p.out + off) = pack8(v);
    }
  }
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver function, fetched through the runtime so
// the library links with nvcc alone.
static inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                     &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess && f != nullptr) fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// A bf16 tensor map with 128-byte swizzle and zero fill outside the tensor:
// ``dims`` innermost first (dims[0] the contiguous channels), ``box`` the
// tile of one load (box[0] = 64 channels = 128 B).
static inline int encode_map(CUtensorMap* map, const void* ptr, int rank,
                             const unsigned long long* dims, const unsigned* box) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  cuuint64_t d[5], strides[4];
  cuuint32_t b[5], e[5];
  unsigned long long stride = 2;
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d,
                        strides, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// The map of ``x`` [N, H, W, C] for kSpatial loads of a th x tw patch.
static inline int spatial_map(CUtensorMap* map, const void* x, int N, int H, int W, int C,
                              int th, int tw) {
  const unsigned long long dims[4] = {(unsigned long long)C, (unsigned long long)W,
                                      (unsigned long long)H, (unsigned long long)N};
  const unsigned box[4] = {BK, (unsigned)tw, (unsigned)th, 1};
  return encode_map(map, x, 4, dims, box);
}

// The map of ``s`` [B, T, H, W, C] for kParity loads of a th x tw patch of
// one frame.
static inline int parity_map(CUtensorMap* map, const void* s, int B, int T, int H, int W,
                             int C, int th, int tw) {
  const unsigned long long dims[5] = {(unsigned long long)C, (unsigned long long)W,
                                      (unsigned long long)H, (unsigned long long)T,
                                      (unsigned long long)B};
  const unsigned box[5] = {BK, (unsigned)tw, (unsigned)th, 1, 1};
  return encode_map(map, s, 5, dims, box);
}

// The map of ``a`` [B, rows, C] for kTemporal loads of BM rows.
static inline int temporal_map(CUtensorMap* map, const void* a, int B, long long rows, int C) {
  const unsigned long long dims[3] = {(unsigned long long)C, (unsigned long long)rows,
                                      (unsigned long long)B};
  const unsigned box[3] = {BK, BM, 1};
  return encode_map(map, a, 3, dims, box);
}

// The map of a K-major weight [Cout, K] for loads of BN rows x 64 channels.
static inline int weight_map(CUtensorMap* map, const void* w, int K, int Cout, int bn) {
  const unsigned long long dims[2] = {(unsigned long long)K, (unsigned long long)Cout};
  const unsigned box[2] = {BK, (unsigned)bn};
  return encode_map(map, w, 2, dims, box);
}

static inline int smem_needed(int bn, int stages) {
  return 1024 + stages * stage_bytes(bn) + 16 * stages;
}

// One conv launch of the plan (bn, stages, smem, grid); map_x is read only
// when p.k_total > p.k_main. Returns a cudaError_t or kErrPlan.
template <int TAPS>
static inline int launch_conv(const CUtensorMap& map_a, const CUtensorMap& map_w,
                              const CUtensorMap& map_x, const Params& p, int bn, int smem,
                              int grid, cudaStream_t s) {
  const int epilogue = BM * (bn + 8) * 4;
  if ((bn != 128 && bn != 256) || p.stages < 2 || smem < smem_needed(bn, p.stages) ||
      p.stages * stage_bytes(bn) < epilogue || p.Cout != p.n_tiles * bn || grid <= 0 ||
      (TAPS == kParity && (p.Cout / 2) % bn != 0))
    return kErrPlan;
  auto kernel = bn == 256 ? conv_kernel<TAPS, 256> : conv_kernel<TAPS, 128>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, bn == 256 ? kThreads<256> : kThreads<128>, smem, s>>>(map_a, map_w, map_x, p);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace vt
