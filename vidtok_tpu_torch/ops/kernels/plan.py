"""Tile plans of the wgmma implicit-GEMM conv (``csrc/wgmma_conv.cuh``)
and of the decoder tail (``csrc/decoder_tail.cu``).

Kernels A, B, E and F, and the temporal microbenchmark's T1 and T2
(``tools/microbench_temporal.py``), launch that loop with a plan made here
from the call's shape, so the shapes stay where the CPU tests reach them:
the patch of an M tile, BN, the ring's stages, the shared memory and the
grid. The loop is persistent: its grid is min(tiles, SMS), and block b
walks tiles b, b + grid, ... (:func:`block_tiles`). Kernels D
and D' launch the tail with :func:`tail_plan`'s patch, run of frames,
stages, shared memory and grid (f32: :func:`tail_plan_f32`'s). Each C
entry takes the plan as it is and refuses one it cannot run.
:func:`tile_origin` mirrors how a block finds a tile's origin from its
index, :func:`tail_block` how a tail block finds its work from
``blockIdx.x``.

f32 (``split=True``): A, B, E and F under the loop's f32 scheme
(``split.py``) run the bf16 plan's tiles, BN, stages and shared memory (a
ring stage holds the same bytes; the K steps are len(PRODUCTS) x); the
plan's ``a_channels`` are the channels the A operand holds a position (the
bf16 pieces, 3x, each piece a plane of its own). D and D' in f32 run
:func:`tail_plan_f32`: :func:`tail_plan`'s blocks with the f32 tail's
stages and shared memory.

The channel domain (:func:`check_channels`): every kernel takes C % 8 == 0,
8 <= C <= 1024, Cin and Cout alike. TMA needs each global stride to be a
multiple of 16 bytes, which a bf16 row of C channels gives only when
C % 8 == 0. A width that is not a multiple of the tiles runs partial tiles,
never padded operands: the K steps of a tap cover Cin in 64-channel boxes
whose last one TMA zero-fills past Cin, in the activation's map and in the
weight's alike (both maps have the true channels as their extent, so no
product reads memory that holds anything but zeros there); the N tiles
cover Cout (E: C per parity) in tiles of BN from {64, 128, 256}, the last
one's columns past Cout zero-filled in the weight's map and not stored.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np

from .split import PIECES

BM, BK = 128, 64                   # rows of an M tile; channels of a K step
PATCHES = ((8, 16), (4, 32))      # th x tw = BM
# the ring's stages, 192 KB at every BN, for one persistent block per SM
# (wgmma_conv.cuh's kBlocksPerSM): two blocks of 288 threads an SM leave
# 96 registers a thread, from which the epilogue spills
STAGES = {64: 8, 128: 6, 256: 4}
BLOCKS_PER_SM = 1
# the epilogue's staging, apart from the ring (wgmma_conv.cuh:
# kStagingBytes): each consumer warpgroup's 64 accumulator rows, one
# chunk of EPILOGUE_CHUNK columns at a time, in f32
EPILOGUE_CHUNK = 64
STAGING_BYTES = 2 * 64 * EPILOGUE_CHUNK * 4
# the channel domain of every kernel (check_channels)
C_ALIGN, C_MAX = 8, 1024
SMEM_LIMIT = 232_448               # bytes of shared memory a block can use
SMEM_PER_SM = 233_472              # of an SM, 1 KB of it reserved per block
SMS = 132                          # streaming multiprocessors of an H100
GRID_LIMIT = 2 ** 31 - 1
ROW_WARPS = 8                     # warps of a row pass's 256-thread block
# TMA's row coordinate is a signed 32-bit int: the rows of one clip
# (temporal) or of a dense operand, plus a tile, must stay below 2^31.
ROW_COORD_LIMIT = 2 ** 31 - 1 - BM
# a tensor map's dimension (cuTensorMapEncodeTiled: globalDim <= 2^32) and
# global stride (< 2^40 bytes, a multiple of 16)
MAP_DIM_LIMIT = 2 ** 32
MAP_STRIDE_LIMIT = 2 ** 40


@dataclass(frozen=True)
class ConvPlan:
    """One launch of the wgmma loop. ``th`` x ``tw`` is the patch of a
    spatial or parity M tile (temporal: 1 x BM rows of a clip); ``tiles_x``
    / ``tiles_y`` the patches across / down a frame (temporal: ``tiles_x``
    M tiles per clip, ``tiles_y`` 1); ``m_tiles`` all M tiles; ``n_tiles``
    the N tiles, ``parities`` x ceil(``cout`` / ``bn``); ``grid`` the
    blocks, min(``tiles``, SMS), each walking the tiles
    :func:`block_tiles` gives it; ``a_channels`` the channels the A
    operand holds a position (f32: the activation's ``PIECES`` pieces);
    ``cout`` the output channels (E: of one parity, C); ``parities`` 2 for
    E's two output frames, else 1; ``frame_tiles`` (temporal, where a
    frame is whole M tiles: S % BM == 0) the M tiles of a frame, which the
    walk takes band by band, the frames of a band fastest, else 0."""
    taps: str
    th: int
    tw: int
    tiles_x: int
    tiles_y: int
    m_tiles: int
    bn: int
    n_tiles: int
    stages: int
    smem: int
    grid: int
    a_channels: int = 0
    cout: int = 0
    parities: int = 1
    frame_tiles: int = 0

    @property
    def tiles(self) -> int:
        """Output tiles: one per (M tile, N tile)."""
        return self.m_tiles * self.n_tiles


def stage_bytes(bn: int) -> int:
    return BM * BK * 2 + bn * BK * 2


def smem_bytes(bn: int, stages: int) -> int:
    """The ring, 1 KB to align it for the 128-byte swizzle, the epilogue's
    staging, the barriers."""
    return 1024 + stages * stage_bytes(bn) + STAGING_BYTES + 16 * stages


def check_channels(c: int, what: str = "C") -> None:
    """Raise unless ``c`` channels are in every kernel's domain: C % 8 == 0
    (TMA's 16-byte strides), 8 <= C <= 1024 (the row passes' registers)."""
    if c % C_ALIGN or c < C_ALIGN:
        raise ValueError(
            f"the kernels take {what} % {C_ALIGN} == 0, got {what}={c}: TMA needs a "
            f"global stride that is a multiple of 16 bytes, and a bf16 row of C "
            f"channels gives one only when C % {C_ALIGN} == 0")
    if c > C_MAX:
        raise ValueError(f"the kernels take {what} <= {C_MAX}, got {what}={c}: a row "
                         f"pass holds at most {C_MAX // 256} vectors of 8 channels a lane")


def _check_channels(cin: int, cout: int, cs: int = 0) -> None:
    check_channels(cin, "Cin")
    check_channels(cout, "Cout")
    if cs:
        check_channels(cs, "Cs")


def k_steps(c: int) -> int:
    """K steps of a tap of ``c`` channels: 64-channel boxes, the last one
    zero-filled past ``c``."""
    return -(-c // BK)


def pick_bn(unit: int, m_tiles: int, parities: int = 1) -> int:
    """BN for N tiles that cover ``unit`` output channels (E: one parity's
    C). 256 reads each A tile once for two N tiles' worth of products, but
    halves the tiles: it is taken only where it divides ``unit`` and the
    tiles still fill the card. Otherwise the tile of {128, 64} that wastes
    the fewest columns in the last N tile, 128 on a tie: 64 is there for
    widths like Cout = 64, where 128 would multiply half zeros, and 192,
    where 128 wastes a quarter (wgmma has n64 as it has n128)."""
    if unit % 256 == 0 and m_tiles * parities * (unit // 256) >= SMS:
        return 256
    return min((128, 64), key=lambda bn: -(-unit // bn) * bn)


def conv_grid(tiles: int) -> int:
    """Blocks of a launch of ``tiles`` tiles: one per SM, fewer where there
    are fewer tiles, so a small launch runs one tile a block."""
    return min(tiles, SMS * BLOCKS_PER_SM)


def _plan(taps, th, tw, tiles_x, tiles_y, m_tiles, cout, parities=1, cin=0,
          split=False) -> ConvPlan:
    bn = pick_bn(cout, m_tiles, parities)
    stages = STAGES[bn]
    n_tiles = parities * -(-cout // bn)
    if m_tiles * n_tiles > GRID_LIMIT:
        raise ValueError(f"{m_tiles * n_tiles} tiles exceed the grid limit")
    plan = ConvPlan(taps, th, tw, tiles_x, tiles_y, m_tiles, bn, n_tiles,
                    stages, smem_bytes(bn, stages), conv_grid(m_tiles * n_tiles),
                    (PIECES if split else 1) * cin, cout, parities)
    if plan.smem > SMEM_LIMIT or BLOCKS_PER_SM * (plan.smem + 1024) > SMEM_PER_SM:
        raise AssertionError(f"plan {plan} does not fit shared memory")
    return plan


def _patch(n: int, h: int, w: int) -> tuple:
    """(th, tw, tiles_x, tiles_y): the patch that covers an h x w frame with
    the fewest tiles, the first of PATCHES on a tie."""
    if min(n, h, w) < 1:
        raise ValueError(f"empty frames: {(n, h, w)}")
    th, tw = min(PATCHES, key=lambda p: -(-h // p[0]) * -(-w // p[1]))
    return th, tw, -(-w // tw), -(-h // th)


def _check_map(dims, elem: int = 2) -> None:
    """Raise unless a tensor map of ``dims`` (innermost first) of
    ``elem``-byte elements is one cuTensorMapEncodeTiled takes."""
    stride = elem
    for i, d in enumerate(dims):
        if d > MAP_DIM_LIMIT or (i and stride >= MAP_STRIDE_LIMIT):
            raise ValueError(f"a tensor map of {tuple(dims)} passes TMA's limits")
        stride *= d


@functools.lru_cache(maxsize=None)
def conv_plan_spatial(n: int, h: int, w: int, cin: int, cout: int,
                      cs: int = 0, split: bool = False) -> ConvPlan:
    """A 3x3 SAME conv of ``[n, h, w, cin]`` to ``cout`` channels (plus a
    1x1 term of ``cs`` channels), in ``_patch``'s patches; ``split``: under
    the f32 scheme."""
    _check_channels(cin, cout, cs)
    th, tw, tiles_x, tiles_y = _patch(n, h, w)
    plan = _plan("spatial", th, tw, tiles_x, tiles_y, n * tiles_x * tiles_y, cout,
                 cin=cin, split=split)
    _check_map((max(cin, cout), w, h, (PIECES if split else 1) * n))
    return plan


@functools.lru_cache(maxsize=None)
def conv_plan_parity(b: int, t: int, h: int, w: int, c: int,
                     split: bool = False) -> ConvPlan:
    """Kernel E over ``[b, t, h, w, c]``: 18 taps of C channels (two frames
    x 3x3) to 2C output columns, the even then the odd output frame, in
    ``_patch``'s patches of one frame; each parity's C columns in N tiles
    of their own, so an N tile is one parity's."""
    check_channels(c)
    th, tw, tiles_x, tiles_y = _patch(b * t, h, w)
    plan = _plan("parity", th, tw, tiles_x, tiles_y, b * t * tiles_x * tiles_y, c, 2,
                 cin=c, split=split)
    _check_map((c, w, h, t, (PIECES if split else 1) * b))
    return plan


@functools.lru_cache(maxsize=None)
def conv_plan_temporal(b: int, t: int, s: int, c: int, split: bool = False) -> ConvPlan:
    """A k=3 time conv of ``b`` clips of ``t`` output frames of ``s`` rows,
    C -> C: over a scratch of ``t + 2`` frames per clip (B, F), or over the
    clips themselves, the zero front from TMA's zero fill (T2 ``mm``)."""
    _check_channels(c, c)
    if min(b, t, s) < 1:
        raise ValueError(f"empty clips: {(b, t, s)}")
    if (t + 2) * s > ROW_COORD_LIMIT:
        raise ValueError(f"a clip of {(t + 2) * s} rows passes TMA's row coordinate")
    per_clip = -(-t * s // BM)
    plan = _plan("temporal", 1, BM, per_clip, 1, b * per_clip, c, cin=c, split=split)
    _check_map((c, (t + 2) * s, (PIECES if split else 1) * b))
    return dataclasses.replace(plan, frame_tiles=0 if s % BM else s // BM)


@functools.lru_cache(maxsize=None)
def conv_plan_dense(m: int, k: int, cout: int) -> ConvPlan:
    """A dense product ``[m, k] x [k, cout]`` (T1's fat product: k = 3C),
    in M tiles of BM consecutive rows: the temporal walk over one clip of
    ``m`` rows; one tap of ``k`` channels, its last K step zero-filled past
    ``k``."""
    check_channels(cout, "Cout")
    if k % C_ALIGN or k < C_ALIGN:
        raise ValueError(f"the wgmma loop takes K % {C_ALIGN} == 0, got K={k}: TMA "
                         f"needs a global stride that is a multiple of 16 bytes")
    if m < 1:
        raise ValueError(f"empty product: {m} rows")
    if m > ROW_COORD_LIMIT:
        raise ValueError(f"{m} rows pass TMA's row coordinate")
    m_tiles = -(-m // BM)
    return _plan("dense", 1, BM, m_tiles, 1, m_tiles, cout)


def block_tiles(plan: ConvPlan, block: int):
    """The tiles block ``block`` walks, in its order: ``block``, + grid,
    ... below ``plan.tiles``."""
    return np.arange(block, plan.tiles, plan.grid)


def walk(plan: ConvPlan):
    """Every tile of the launch's walk: each block's :func:`block_tiles`,
    block after block."""
    return np.concatenate([block_tiles(plan, b) for b in range(plan.grid)])


def tile_origin(plan: ConvPlan, tile) -> tuple:
    """(M tile origin, first output column) of tile ``tile``, as the
    kernel decodes a tile's index (wgmma_conv.cuh: tile_at): spatial and
    parity ``(frame, y0, x0)`` (parity: frame ``b * t + a`` of the input),
    temporal and dense ``(clip, r0)`` (dense: clip 0; temporal with
    ``frame_tiles``: M tile k of a clip is band k // T of frame k % T); the
    N tiles of one M tile are neighbours. E's columns count both parities,
    parity p's C columns from p * C on."""
    nt = tile % plan.n_tiles
    per = plan.n_tiles // plan.parities
    n0 = (nt // per) * plan.cout + (nt % per) * plan.bn
    mt = tile // plan.n_tiles
    if plan.taps in ("spatial", "parity"):
        q, tx = divmod(mt, plan.tiles_x)
        img, ty = divmod(q, plan.tiles_y)
        return (img, ty * plan.th, tx * plan.tw), n0
    clip, rt = divmod(mt, plan.tiles_x)
    if plan.frame_tiles:
        band, frame = divmod(rt, plan.tiles_x // plan.frame_tiles)
        rt = frame * plan.frame_tiles + band
    return (clip, rt * BM), n0


def tile_columns(plan: ConvPlan, tile) -> tuple:
    """[first, end) of the output columns of tile ``tile`` (E's counted as
    in :func:`tile_origin`): its N tile's, less those past the parity's
    ``cout``, which the epilogue does not store."""
    _, n0 = tile_origin(plan, tile)
    par = n0 // plan.cout
    return n0, par * plan.cout + np.minimum(n0 - par * plan.cout + plan.bn, plan.cout)


def k_step_reads(plan_taps: int, cin: int, cs: int = 0) -> list:
    """What each K step of one product loads, as the producer decodes it:
    ``(tap, c0, c1)``, channels [c0, c1) of tap ``tap`` (the 1x1 term's
    ``tap == plan_taps``), each a 64-channel box whose channels from c1 on
    are TMA's zero fill."""
    steps = k_steps(cin)
    reads = []
    for kb in range(plan_taps * steps + (k_steps(cs) if cs else 0)):
        if kb < plan_taps * steps:
            tap, c0 = divmod(kb, steps)
            c0 *= BK
            reads.append((tap, c0, min(c0 + BK, cin)))
        else:
            c0 = (kb - plan_taps * steps) * BK
            reads.append((plan_taps, c0, min(c0 + BK, cs)))
    return reads


def row_layout(c: int) -> tuple:
    """The row passes' layout of C channels (common.cuh: VT_ROW_LAYOUTS;
    act_rows_kernel and the microbenchmark's exact passes): (LPR lanes a
    row, VPL 16-byte vectors of 8 channels a lane, RPT rows a thread). LPR
    is the power of two from 8 to 32 that holds C / 8 vectors, so the xor
    shuffles reduce within a row; lane l's vector i holds channels
    8 l + 8 LPR i .. + 7, and a vector from channel C on is masked: loaded
    as zeros, left out of the statistics, never stored."""
    check_channels(c)
    lpr = min(32, max(8, 1 << (c // 8 - 1).bit_length()))
    vpl = -(-c // (8 * lpr))
    return lpr, vpl, {1: 4, 2: 2}.get(vpl, 1)


def check_row_channels(c: int) -> None:
    """Raise unless the LN+SiLU row passes take ``c`` channels."""
    row_layout(c)


# The decoder tail (kernels D and D'). A block walks the frames of one
# TAIL_TH x TAIL_TW output patch of one clip; each input frame's halo box,
# (TAIL_TH + 2) x (TAIL_TW + 2) positions (16 wide, so a dy shift of the
# GEMM's A rows is 16 rows of 128 B, a whole number of swizzle atoms), is
# loaded once per 64 channels, activated once, and multiplied once per dy
# by [C, TAIL_BN] weights: 27 (time tap, dx, out channel) columns padded to
# TAIL_BN. A run that starts at frame t0 > 0 first takes TAIL_WARMUP
# frames before it. C past TAIL_GROUP channels runs in groups of up to
# TAIL_GROUP channels, one launch each, behind a pass that writes each
# position's LN statistics: every launch adds its channels' partial sums
# to an f32 accumulator, the last one adds the bias and writes the output.
TAIL_TH, TAIL_TW = 8, 14
TAIL_HALO = (TAIL_TH + 2) * (TAIL_TW + 2)      # positions of a halo box
TAIL_M = TAIL_TH * (TAIL_TW + 2)               # GEMM rows: two m64 tiles
TAIL_COLS, TAIL_BN = 27, 32
TAIL_GROUP = 128                              # channels a tail launch takes
TAIL_WARMUP = 2
TAIL_MAX_STAGES = 4
TAIL_BLOCKS_PER_SM = 1


@dataclass(frozen=True)
class TailPlan:
    """One launch of the decoder tail: ``tiles_x`` x ``tiles_y`` patches of
    ``th`` x ``tw`` per frame, each clip's frames cut into ``runs`` runs of
    ``run`` frames (the last may be shorter); ``grid`` blocks, one per
    (patch, clip, run); ``stages`` halo boxes in flight; ``smem`` bytes;
    ``groups`` launches of up to TAIL_GROUP channels each (one for C <=
    TAIL_GROUP)."""
    th: int
    tw: int
    tiles_x: int
    tiles_y: int
    run: int
    runs: int
    stages: int
    smem: int
    grid: int
    groups: int = 1


def tail_group(c: int) -> int:
    """The channels of a tail launch over C channels (the widest group)."""
    return min(c, TAIL_GROUP)


def tail_groups(c: int) -> list:
    """[c0, c1) of each tail launch's channels, in launch order."""
    return [(c0, min(c0 + TAIL_GROUP, c)) for c0 in range(0, c, TAIL_GROUP)]


def tail_stage_bytes(c: int) -> int:
    """One frame's halo box of a group: ceil(group / 64) channel slices of
    TAIL_HALO rows of 128 B, the last zero-filled past C by TMA."""
    return k_steps(tail_group(c)) * TAIL_HALO * 128


def tail_smem_bytes(c: int, stages: int) -> int:
    """1 KB to align the swizzled boxes, the ring of halo boxes, the
    weights (3 dy x ceil(group / 64) tiles of TAIL_BN rows of 128 B), two
    f32 partial buffers [TAIL_M, TAIL_COLS], the full, activated and empty
    barriers of each stage."""
    return (1024 + stages * tail_stage_bytes(c) + 3 * k_steps(tail_group(c)) * TAIL_BN * 128
            + 2 * TAIL_M * TAIL_COLS * 4 + 24 * stages)


@functools.lru_cache(maxsize=None)
def tail_plan(b: int, t: int, h: int, w: int, c: int) -> TailPlan:
    """Kernels D and D' over ``[b, t, h, w, c]``. The run is the one that
    finishes first if every block takes as long as its frames, warm-up
    included, and blocks go out in waves of SMS x TAIL_BLOCKS_PER_SM; the
    longest such run on a tie (fewer warm-up frames)."""
    if min(b, t, h, w) < 1:
        raise ValueError(f"empty clips: {(b, t, h, w)}")
    check_channels(c)
    tiles_x, tiles_y = -(-w // TAIL_TW), -(-h // TAIL_TH)
    patches = b * tiles_x * tiles_y
    best = None
    for run in range(t, 0, -1):
        runs = -(-t // run)
        waves = -(-patches * runs // (SMS * TAIL_BLOCKS_PER_SM))
        cost = waves * (run + (TAIL_WARMUP if runs > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, run, runs)
    _, run, runs = best
    fixed = tail_smem_bytes(c, 0)
    stages = min(TAIL_MAX_STAGES, (SMEM_LIMIT - fixed) // (tail_stage_bytes(c) + 24))
    plan = TailPlan(TAIL_TH, TAIL_TW, tiles_x, tiles_y, run, runs, stages,
                    tail_smem_bytes(c, stages), patches * runs, len(tail_groups(c)))
    if stages < 2 or plan.smem > SMEM_LIMIT:
        raise AssertionError(f"plan {plan} does not fit shared memory")
    if plan.grid > GRID_LIMIT:
        raise ValueError(f"{plan.grid} blocks exceed the grid limit")
    return plan


def tail_block(plan: TailPlan, block: int, t: int) -> tuple:
    """(clip, y0, x0, t0, t1, first frame read) of block ``block``, as the
    kernel decodes ``blockIdx.x``: it writes output frames [t0, t1) of its
    patch and reads input frames from max(t0 - TAIL_WARMUP, 0)."""
    q, tx = divmod(block, plan.tiles_x)
    q, ty = divmod(q, plan.tiles_y)
    clip, r = divmod(q, plan.runs)
    t0 = r * plan.run
    return (clip, ty * plan.th, tx * plan.tw, t0, min(t, t0 + plan.run),
            max(t0 - TAIL_WARMUP, 0))


# Kernels D and D' in f32 (decoder_tail.cu: tail_f32_kernel): tail_plan's
# blocks, runs, patch and groups; a unit is one frame's TAIL_F32_KC-channel
# slice, its raw f32 halo box in a ring of ``stages`` raw stages, its three
# bf16 pieces in one of TAIL_F32_PIECE_STAGES piece stages; the group's
# weight pieces [PIECES][3 dy][TAIL_BN][group] stay resident as (piece, dy,
# slice) tiles of TAIL_BN rows of 64 B.
TAIL_F32_KC = 32
TAIL_F32_RAW = TAIL_HALO * TAIL_F32_KC * 4
TAIL_F32_PIECE = TAIL_HALO * TAIL_F32_KC * 2
TAIL_F32_PIECE_STAGES = 2


def tail_f32_smem_bytes(c: int, stages: int) -> int:
    """1 KB to align the swizzled tiles, the raw stages, the piece stages,
    the weight pieces, two f32 partial buffers, two barriers a stage."""
    return (1024 + stages * TAIL_F32_RAW + TAIL_F32_PIECE_STAGES * PIECES * TAIL_F32_PIECE
            + PIECES * 3 * -(-tail_group(c) // TAIL_F32_KC) * TAIL_BN * TAIL_F32_KC * 2
            + 2 * TAIL_M * TAIL_COLS * 4 + 16 * (stages + TAIL_F32_PIECE_STAGES))


@functools.lru_cache(maxsize=None)
def tail_plan_f32(b: int, t: int, h: int, w: int, c: int) -> TailPlan:
    """Kernels D and D' over f32 ``[b, t, h, w, c]``: :func:`tail_plan`'s
    patches and runs, as many raw stages (up to TAIL_MAX_STAGES) as the
    shared memory holds."""
    pl = tail_plan(b, t, h, w, c)
    fixed = tail_f32_smem_bytes(c, 0)
    stages = min(TAIL_MAX_STAGES, (SMEM_LIMIT - fixed) // (TAIL_F32_RAW + 16))
    plan = dataclasses.replace(pl, stages=stages, smem=tail_f32_smem_bytes(c, stages))
    if stages < 2 or plan.smem > SMEM_LIMIT:
        raise AssertionError(f"plan {plan} does not fit shared memory")
    return plan
