"""Kernels J and K (``ops/kernels/temporal_linear.py``): the v1.1 trilinear
temporal upsample's two passes around its cuDNN conv.

On the CPU: J's and K's plain forms against the chain the module ran
before them, spelled out here (``interp.temporal_linear_up2x`` of the head
and tail, their ``cat``, the conv's front from ``pad_time_front`` or
``Stream.front``, the conv, its bias added after it as PyTorch's cuDNN path
adds it, the blend), bit for bit in f32 and bf16, in every case the decoder
reaches: no stream with ntu 1 and 2, a clip of ntu frames (no tail), the
zero front, a stream's first chunk and later chunks at cache offsets 0, 2
and 4; and ``TimeUpsampleRes2x`` with ``fused`` (the wrappers' plain forms)
against the same chain, with the caches it leaves.

On the card (marker ``card``; this file imports no JAX, so the card's
machine runs it alone: ``python3 -m pytest --noconftest
tests/test_torch_temporal_linear.py -m card``): J against its plain form
bit for bit in bf16 and f32, K in f32 and within the bf16 gate in bf16, at
the tiled benchmark cell's two upsample shapes and chunk lengths, at a
width that is a multiple of 8 and not a power of 2, and at widths that are
not.
"""

import pytest
import torch

from vidtok_tpu_torch.modules import interp
from vidtok_tpu_torch.modules.blocks import TimeUpsampleRes2x
from vidtok_tpu_torch.modules.conv import conv3d_cl, pad_time_front
from vidtok_tpu_torch.modules.stream import Stream
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels.temporal_linear import (linear_blend_plain,
                                                          temporal_linear_up2x_plain)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# case -> (ntu, first_pad_mode, chunk frames, None (no stream), "first" (a
# stream's first chunk) or a later chunk's cache offset)
CASES = {"ntu1": (1, "replicate", 5, None), "ntu2": (2, "replicate", 5, None),
         "t-is-ntu": (2, "replicate", 2, None), "zero-front": (2, "zero", 4, None),
         "first-chunk": (2, "replicate", 4, "first"), "later-off0": (2, "replicate", 3, 0),
         "later-off2": (2, "replicate", 5, 2), "later-off4": (2, "replicate", 3, 4)}
C = 16


def module(ntu, mode, off):
    m = TimeUpsampleRes2x(C, C, ntu, mode, cache_offset=off)
    m.conv.reset_params(torch.Generator().manual_seed(1))
    with torch.no_grad():
        m.mix_factor.fill_(0.3)
    return m


def clip(t, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, t, 6, 5, C), generator=g).to(dtype)


def chain(m, x, stream):
    """The parent module's trilinear branch up to the conv's input: (up,
    the conv's fronted input), the caches written into ``stream``."""
    ntu = m.ntu
    if stream is not None and not stream.first_chunk:
        xc = torch.cat([stream.get(m).to(x.dtype), x], dim=1)
        stream.put(m, xc[:, -2 * ntu:-ntu].clone())
        up = interp.temporal_linear_up2x(xc)[:, 2 * ntu:]
    else:
        if stream is not None:
            stream.put(m, x[:, -ntu:].clone())
        up = interp.temporal_linear_up2x(x[:, :ntu])
        if x.shape[1] > ntu:
            up = torch.cat([up, interp.temporal_linear_up2x(x[:, ntu:])], dim=1)
    if stream is None:
        return up, pad_time_front(up, 2, m.first_pad_mode)
    return up, stream.front(m.conv, up, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_forms_equal_the_chain(case, dtype):
    ntu, mode, t, where = CASES[case]
    dt = DTYPES[dtype]
    off = where if isinstance(where, int) else 2
    m = module(ntu, mode, off)
    x = clip(t, dt, 2)
    cache = None
    with torch.no_grad():
        if isinstance(where, int):  # the previous chunk's caches, plain
            s0 = Stream(m, None, True, use_cache_offset=True)
            m(clip(4, dt, 3), stream=s0)
            cache = s0.new

        def stream():
            return None if where is None else Stream(
                m, cache, where == "first", use_cache_offset=True)

        ref = stream()
        up, full = chain(m, x, ref)
        later = isinstance(where, int)
        prev = cache[""].to(dt) if later else None
        front = (cache["conv"].to(dt) if later
                 else "replicate" if where == "first" else mode)
        got = temporal_linear_up2x_plain(x, 0 if later else ntu, prev, front)
        assert got.dtype == dt and torch.equal(got, full)

        w, bias = m.conv.conv.weight, m.conv.conv.bias
        y = conv3d_cl(full, w, None, (1, 1, 1), (0, 1, 1))
        alpha = torch.sigmoid(m.mix_factor).to(dt)
        want = alpha * up + (1 - alpha) * (y + bias.to(dt))
        assert torch.equal(linear_blend_plain(full, y, bias, alpha.float()), want)

        fused = stream()
        K.reset_counts()
        out = m(x, fused=True, stream=fused)
    assert torch.equal(out, want)
    calls = K.counts("calls")
    assert calls["temporal_linear_up2x"] == calls["linear_blend"] == 1
    assert all(n == 0 for n in K.counts().values())  # CPU: no launches
    if where is not None:
        assert fused.new.keys() == ref.new.keys() == {"", "conv"}
        for k in ref.new:
            assert torch.equal(fused.new[k], ref.new[k]), k


def test_plain_j_takes_one_frame_of_prev_and_any_split():
    """J reads only the last frame of ``prev``; a split past T is one
    segment; split 0 without ``prev`` clamps frame 0 to itself."""
    x = clip(4, torch.float32, 5)
    prev = clip(3, torch.float32, 6)
    a = temporal_linear_up2x_plain(x, 0, prev, "zero")
    b = temporal_linear_up2x_plain(x, 0, prev[:, -1:], "zero")
    assert torch.equal(a, b) and torch.equal(a[:, :2], torch.zeros_like(a[:, :2]))
    whole = interp.temporal_linear_up2x(x)
    assert torch.equal(temporal_linear_up2x_plain(x, 9, None, "replicate")[:, 2:], whole)
    assert torch.equal(temporal_linear_up2x_plain(x, 0, None, "replicate")[:, 2:], whole)


def test_wrappers_refuse_an_unknown_front():
    with pytest.raises(ValueError, match="unknown front"):
        K.temporal_linear_up2x(clip(2, torch.float32, 7), 1, None, "reflect")


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tiled_cases():
    """(shape, ntu, later) of J at the tiled cell's decoder chunks
    (``[1,3,201,256²]`` clips, ``t_chunk_enc`` 16): n latents a chunk give
    (n, 128², 512) at ntu 1 and (2n, 256², 256) at ntu 2; each length once
    as a first chunk and once as a later one."""
    from vtbench.reference.work import chunk_schedule

    _, dec = chunk_schedule(201)
    out = []
    for n in sorted(set(dec)):
        for later in (False, True):
            out += [((1, n, 128, 128, 512), 1, later), ((1, 2 * n, 256, 256, 256), 2, later)]
    return out


RAGGED = [((2, 5, 33, 33, c), ntu, later) for c in (200, 36, 37)
          for ntu, later in ((1, False), (2, False), (5, False), (2, True))]
CARD_CASES = _tiled_cases() + RAGGED


def _j_args(shape, ntu, later, dt, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    b, t, h, w, c = shape

    def draw(*s):
        return torch.randn(s, generator=g, device=device).to(dt)

    x = draw(b, t, h, w, c)
    if later:
        return x, 0, draw(b, ntu, h, w, c), draw(b, 2, h, w, c)
    return x, ntu, None, "replicate"


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,ntu,later", CARD_CASES)
def test_kernel_j_bit_equal_on_card(card, shape, ntu, later, dtype):
    args = _j_args(shape, ntu, later, DTYPES[dtype], card, 11)
    K.reset_counts()
    got = K.temporal_linear_up2x(*args)
    want = temporal_linear_up2x_plain(*args)
    torch.cuda.synchronize()
    assert K.counts()["temporal_linear_up2x"] == 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,ntu,later", CARD_CASES)
def test_kernel_k_on_card(card, shape, ntu, later, dtype):
    """f32: bit for bit. bf16: the f32 plain form's answer within the repo's
    bf16 gate (``chip_smoke.KERNEL_GATE``, and ``BF16_SLACK`` x the plain
    bf16 form's own distance from it)."""
    dt = DTYPES[dtype]
    b, t, h, w, c = shape
    g = torch.Generator(card).manual_seed(13)
    full = torch.randn((b, 2 * t + 2, h, w, c), generator=g, device=card).to(dt)
    y = torch.randn((b, 2 * t, h, w, c), generator=g, device=card).to(dt)
    bias = 0.1 * torch.randn(c, generator=g, device=card)
    alpha = torch.sigmoid(torch.tensor([2.0], device=card)).to(dt).float()
    want = linear_blend_plain(full, y, bias, alpha)
    K.reset_counts()
    got = K.linear_blend(full, y.clone(), bias, alpha)
    torch.cuda.synchronize()
    assert K.counts()["linear_blend"] == 1
    if dt == torch.float32:
        assert torch.equal(got, want)
        return
    ref = linear_blend_plain(full.float(), y.float(), bias, alpha)
    rel, plain_rel = _rel(got, ref), _rel(want, ref)
    assert rel <= 1e-2 and rel <= 1.1 * plain_rel, (rel, plain_rel)
