"""Kernels A-F on f32 activations, against the JAX package's Pallas kernels
in f32.

On the card A, B, E and F take f32 through the wgmma loop's f32 scheme
(``ops/kernels/split.py``): each f32 operand split into three bf16 pieces,
six products of pieces summed in f32; D and D' run the same scheme in the
decoder tail; C, G, H and I are templates of the element type. Here the
scheme's arithmetic is written in PyTorch (the split, then each product in
f32) and held on the CPU against the JAX kernel in interpret mode in f32,
on inputs from a numpy seed at ``tests/test_torch_kernels.py``'s sizes:
relative L2 at most REL (2e-5, the gate ``chip_smoke`` holds the card's
f32 kernels to against their plain versions); the tail's walk is modelled
in ``tests/test_torch_tail.py``. Then the engine's default (the kernels on
for a CUDA device in bf16 and f32), the ten serving wrappers taking f32 and
refusing other dtypes (the meta device standing in for a card), and the
f32 operands' layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vidtok_tpu.modules.blocks as JB
from vidtok_tpu.ops.pallas.decoder_tail import decoder_tail_rgb as j_tail
from vidtok_tpu.ops.pallas.fused_spatial_v2 import fused_spatial_resblock_v2
from vidtok_tpu.ops.pallas.fused_temporal import fused_temporal_resblock as j_temporal
from vidtok_tpu.ops.pallas.fused_temporal import fused_temporal_resblock_stream as j_stream
from vidtok_tpu.ops.pallas.parity_upsample_fused import parity_up2x_fused as j_parity
from vidtok_tpu.ops.pallas import upsample_epilogue as JU
from vidtok_tpu.ops.pallas.subpixel_epilogue import subpixel_interleave as j_subpixel
from vidtok_tpu.ops.pallas.subpixel_epilogue import subpixel_interleave_z as j_sub_z
from vidtok_tpu_torch.convert import state_dict_from_jax
from vidtok_tpu_torch.models.autoencoder import fused_default
from vidtok_tpu_torch.modules import blocks as TB
from vidtok_tpu_torch.ops import kernels as K
from vidtok_tpu_torch.ops.kernels import plan
from vidtok_tpu_torch.ops.kernels.act import ln_silu_f32, ln_silu_fast
from vidtok_tpu_torch.ops.kernels.decoder_tail import (decoder_tail_rgb_plain,
                                                       tail_operands, tail_operands_f32)
from vidtok_tpu_torch.ops.kernels.fused_spatial import (fused_spatial_resblock_plain,
                                                        spatial_operands)
from vidtok_tpu_torch.ops.kernels.fused_temporal import (
    fused_temporal_resblock_plain, fused_temporal_resblock_stream_plain, kmajor_weight,
    temporal_operands)
from vidtok_tpu_torch.ops.kernels.parity_upsample import (parity_operands,
                                                          parity_operands_f32,
                                                          parity_up2x_fused_plain)
from vidtok_tpu_torch.ops.kernels.split import (PIECES, PRODUCTS, kmajor_pieces,
                                                product_sum, split)
from vidtok_tpu_torch.ops.kernels.subpixel import (subpixel_interleave_plain,
                                                   subpixel_interleave_z_plain)
from vidtok_tpu_torch.ops.kernels.upsample_epilogue import (parity_blend_interleave4_plain,
                                                            parity_blend_interleave_plain)

torch.set_num_threads(2)
REL = 2e-5


def randomize(tree, rng):
    """Random leaves: norm scales 1 +- 0.2, everything else N(0, 0.1)."""
    def leaf(path, a):
        r = rng.randn(*a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return 1.0 + 0.2 * r
        return 0.1 * r

    return jax.tree_util.tree_map_with_path(leaf, tree)


def load_port(module, params, path, prefix):
    tree = params
    for name in reversed(path):
        tree = {name: tree}
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(tree).items()}
    module.load_state_dict(sd, strict=True)
    return module


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want):
    assert rel_l2(got, want) <= REL


# -- the scheme's arithmetic, kernel by kernel --------------------------------

def conv3x3(h, w):
    """[N, H, W, Ci] x OIHW -> [N, H, W, Co], SAME, f32."""
    return F.conv2d(h.permute(0, 3, 1, 2), w, None, 1, 1).permute(0, 2, 3, 1)


def scheme_a(x, norm1, conv1, norm2, conv2, nin=None, ln=ln_silu_f32):
    """Kernel A in f32: both convs and the 1x1 shortcut as the six products
    of their pieces (the shortcut's bias folded into conv2's, its products
    in conv2's accumulator). ``ln``: the row passes' LN+SiLU."""
    h = ln(x, *norm1)
    c1 = product_sum(conv3x3, h, conv1[0]) + conv1[1]
    h = ln(c1, *norm2)
    y = product_sum(conv3x3, h, conv2[0])
    if nin is None:
        return x + (y + conv2[1])
    sc = product_sum(lambda a, w: a @ w.t(), x, nin[0][:, :, 0, 0])
    return (y + sc) + (conv2[1] + nin[1])


def tconv(front, a, w):
    """The causal k=3 time conv of ``[front | a]`` (front 2 frames) by a
    Conv1d weight [O, I, 3], f32, as the six products: a GEMM per tap."""
    full = torch.cat([front, a], dim=1)
    n = a.shape[1]
    return sum(product_sum(lambda p, q: p @ q.t(), full[:, k:k + n], w[..., k])
               for k in range(3))


def front_of(a, mode):
    return a[:, :1].expand(-1, 2, *a.shape[2:]) if mode == "replicate" else torch.zeros_like(a[:, :2])


def scheme_b(x, norm1, conv1, norm2, conv2, mode, ln=ln_silu_f32):
    a = ln(x, *norm1)
    h = tconv(front_of(a, mode), a, conv1[0]) + conv1[1]
    a = ln(h, *norm2)
    return x + (tconv(front_of(a, mode), a, conv2[0]) + conv2[1])


def scheme_f(x, norm1, conv1, norm2, conv2, c1, c2, first, offset, ln=ln_silu_f32):
    """Kernel F in f32: the scratch's front is the f32 cache (split as it
    enters), the new caches the f32 activations ``offset`` frames back."""
    n = x.shape[1]

    def step(a, cache, conv):
        front = front_of(a, "replicate") if first else cache
        full = torch.cat([front, a], dim=1)
        return tconv(front, a, conv[0]) + conv[1], full[:, n - offset:n - offset + 2]

    h, nc1 = step(ln(x, *norm1), c1, conv1)
    y, nc2 = step(ln(h, *norm2), c2, conv2)
    return x + y, nc1, nc2


def scheme_e(s, weight, bias, alpha, mode):
    """Kernel E in f32: ``[[K0+K1, K0], [K2, K1+K2]]`` summed in f32 and
    split once, s split, the 18 taps' products in one f32 sum per output,
    the blend in f32."""
    b, t_, h, w, c = s.shape
    # the f32 summed weight, K-major [2C, (frame, dy, dx, ci)], whose pieces
    # are the kernel's operand
    k0, k1, k2 = weight.float().permute(2, 3, 4, 1, 0)
    wf = torch.stack([torch.cat([k0 + k1, k0], dim=-1),
                      torch.cat([k2, k1 + k2], dim=-1)]).reshape(18 * c, 2 * c).t()
    assert torch.equal(kmajor_pieces(wf), parity_operands_f32(weight, bias)["w"])
    prev = torch.cat([s[:, :1] if mode == "replicate" else torch.zeros_like(s[:, :1]),
                      s[:, :-1]], dim=1)

    def taps(frames):
        # [B, T, H, W, 9C]: the 3x3 neighbourhood, (dy, dx, ci), zero padded
        p = F.pad(frames, (0, 0, 1, 1, 1, 1))
        return torch.cat([p[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                         dim=-1)

    a = torch.cat([taps(prev), taps(s)], dim=-1)               # [B, T, H, W, 18C]
    y = product_sum(lambda p, q: p @ q.t(), a, wf) + torch.cat([bias, bias])
    y = y.reshape(b, t_, h, w, 2, c)
    out = alpha * s[:, :, :, :, None] + (1 - alpha) * y
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * t_, h, w, c)


# -- against JAX ----------------------------------------------------------------

def test_split_holds_f32():
    """The three pieces are bf16, their f32 sum is x to 2^-24 of |x|, and
    the six products are those whose pieces' orders add up to at most 2,
    each once."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32)) * 3
    pieces = split(x)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (PIECES, 4096)
    back = sum(p.double() for p in pieces)
    assert ((back - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    assert sorted(PRODUCTS) == sorted((i, j) for i in range(3) for j in range(3) if i + j <= 2)
    # the loop runs them smallest first
    assert [i + j for i, j in PRODUCTS] == sorted((i + j for i, j in PRODUCTS), reverse=True)


@pytest.mark.parametrize("h,w,cin,cout", [(32, 8, 32, 32), (32, 8, 16, 32),
                                          (32, 24, 32, 16)])
def test_kernel_a_scheme_f32(h, w, cin, cout):
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, h, w, cin).astype(np.float32)
    jm = JB.ResnetBlockSpatial(cout, norm_type="layernorm")
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = fused_spatial_resblock_v2(jnp.asarray(x.reshape(2, h, w, cin)), p, interpret=True)
    assert want.dtype == jnp.float32
    tm = load_port(TB.ResnetBlockSpatial(cin, cout), p,
                   ("encoder", "down_0_block_0"), "encoder.down.0.block.0.")
    nin = ((tm.nin_shortcut.weight, tm.nin_shortcut.bias) if cin != cout else None)
    args = ((tm.norm1.norm.weight, tm.norm1.norm.bias), (tm.conv1.weight, tm.conv1.bias),
            (tm.norm2.norm.weight, tm.norm2.norm.bias), (tm.conv2.weight, tm.conv2.bias), nin)
    xt = t(x.reshape(2, h, w, cin))
    with torch.no_grad():
        close(scheme_a(xt, *args), want)
        close(fused_spatial_resblock_plain(xt, *args), want)


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_kernel_b_scheme_f32(mode):
    rng = np.random.RandomState(1)
    x = rng.randn(1, 5, 8, 8, 32).astype(np.float32)
    jm = JB.ResnetBlockTemporal(32, causal=True, norm_type="layernorm", first_pad_mode=mode)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = j_temporal(jnp.asarray(x), p, mode, interpret=True)
    tm = load_port(TB.ResnetBlockTemporal(32, 32, first_pad_mode=mode), p,
                   ("encoder", "down_temporal_0_block_0"), "encoder.down_temporal.0.block.0.")
    args = ((tm.norm1.norm.weight, tm.norm1.norm.bias), (tm.conv1.conv.weight, tm.conv1.conv.bias),
            (tm.norm2.norm.weight, tm.norm2.norm.bias), (tm.conv2.conv.weight, tm.conv2.conv.bias))
    with torch.no_grad():
        close(scheme_b(t(x), *args, mode), want)
        close(fused_temporal_resblock_plain(t(x), *args, mode), want)


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_kernel_f_scheme_f32(offset):
    """Three chunks through F's scheme, the f32 caches carried, against the
    Pallas stream kernel (interpret, f32) on y and both new caches, at
    cache offsets 0, 1, 2 and 4."""
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 8, 16, 128
    n = max(1, offset)
    chunks = [(rng.randn(b, k, h, w, c) * 0.5).astype(np.float32) for k in (n, 4 * n, 4 * n)]
    jm = JB.ResnetBlockTemporal(c, causal=True, norm_type="layernorm",
                                first_pad_mode="replicate", cache_offset=offset)
    p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(chunks[0]))["params"], rng)
    tm = load_port(TB.ResnetBlockTemporal(c, c, first_pad_mode="replicate", cache_offset=offset),
                   p, ("decoder", "up_temporal_1_block_0"), "decoder.up_temporal.1.block.0.")
    args = ((tm.norm1.norm.weight, tm.norm1.norm.bias), (tm.conv1.conv.weight, tm.conv1.conv.bias),
            (tm.norm2.norm.weight, tm.norm2.norm.bias), (tm.conv2.conv.weight, tm.conv2.conv.bias))
    jc1 = jc2 = jnp.zeros((b, 2, h, w, c), jnp.float32)
    c1 = c2 = None
    with torch.no_grad():
        for i, x in enumerate(chunks):
            jy, jc1, jc2 = j_stream(jnp.asarray(x), p, jc1, jc2, first_chunk=i == 0,
                                    offset=offset, interpret=True)
            y, c1, c2 = scheme_f(t(x), *args, c1, c2, i == 0, offset)
            py = fused_temporal_resblock_stream_plain(t(x), *args, c1 if i else None,
                                                      c2 if i else None, i == 0, offset)[0]
            for got, ref in ((y, jy), (c1, jc1), (c2, jc2)):
                close(got, ref)
            if i == 0:
                close(py, jy)


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_kernel_e_scheme_f32(mode):
    """test_fast_paths.py:159-176's shapes and seed, C=64, in f32."""
    rng = np.random.RandomState(1)
    s = rng.randn(1, 3, 8, 16, 64).astype("float32")
    k = rng.randn(3, 3, 3, 64, 64).astype("float32") * 0.05
    bias = rng.randn(64).astype("float32") * 0.1
    want = j_parity(jnp.asarray(s), jnp.asarray(k), jnp.asarray(bias), 0.3, mode,
                    interpret=True)
    assert want.dtype == jnp.float32
    weight = t(k.transpose(4, 3, 0, 1, 2))                  # OIDHW
    alpha = torch.tensor([0.3])
    close(scheme_e(t(s), weight, t(bias), alpha, mode), want)
    close(parity_up2x_fused_plain(t(s), weight, t(bias), alpha, mode), want)


def test_kernel_c_f32():
    """C's f32 form adds the bias in f32, the tile dtype: exact."""
    rng = np.random.RandomState(2)
    ys = [rng.randn(3, 4, 6, 16).astype(np.float32) for _ in range(4)]
    bias = rng.randn(16).astype(np.float32)
    want = j_subpixel(*map(jnp.asarray, ys), jnp.asarray(bias), interpret=True)
    got = subpixel_interleave_plain(*map(t, ys), t(bias))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel,mode", [("G", "zero"), ("G", "replicate"), ("H", "zero"),
                                         ("H", "replicate"), ("I", None)])
def test_epilogues_f32(kernel, mode):
    """G, H and I on f32 inputs: the function in f32 (the sum, the bias and
    the blend; I's bias in the tile dtype), as their f32 templates compute
    it, against the Pallas kernels in f32."""
    rng = np.random.RandomState(5)
    if kernel == "I":
        n, h, w, c = 2, 12, 20, 16
        z = rng.randn(n, h + 1, w + 1, 4 * c).astype(np.float32)
        bias = rng.randn(c).astype(np.float32)
        want = j_sub_z(jnp.asarray(z), jnp.asarray(bias), c, interpret=True)
        got = subpixel_interleave_z_plain(t(z), t(bias))
    else:
        b, tt, h, w, c = 1, 3, 4, 8, 16
        s = rng.randn(b, tt, h, w, c).astype(np.float32)
        y4 = rng.randn(b, tt, h, w, 4 * c).astype(np.float32)
        bias = (0.1 * rng.randn(c)).astype(np.float32)
        alpha = torch.tensor([0.7])
        if kernel == "G":
            yc, yp = y4[..., :2 * c], y4[..., 2 * c:]
            want = JU.parity_blend_interleave(jnp.asarray(s), jnp.asarray(yc), jnp.asarray(yp),
                                              jnp.asarray(bias), 0.7, mode, interpret=True)
            got = parity_blend_interleave_plain(t(s), t(yc), t(yp), t(bias), alpha, mode)
        else:
            want = JU.parity_blend_interleave4(jnp.asarray(s), jnp.asarray(y4),
                                               jnp.asarray(bias), 0.7, mode, interpret=True)
            got = parity_blend_interleave4_plain(t(s), t(y4), t(bias), alpha, mode)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("mode", ["zero", "replicate"])
def test_kernel_d_f32(mode):
    """D's f32 form: the f32 activation, then the conv's six products
    through the weight pieces its kernel reads (tail_operands_f32), tap by
    tap, against the Pallas tail in f32."""
    rng = np.random.RandomState(3)
    c = 32
    x = (rng.randn(1, 5, 16, 24, c) * 0.5).astype(np.float32)
    norm = {"scale": 1 + 0.2 * rng.randn(c).astype(np.float32),
            "bias": 0.2 * rng.randn(c).astype(np.float32)}
    conv = {"kernel": 0.05 * rng.randn(3, 3, 3, c, 3).astype(np.float32),
            "bias": 0.1 * rng.randn(3).astype(np.float32)}
    want = j_tail(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, norm),
                  jax.tree_util.tree_map(jnp.asarray, conv), mode, interpret=True)
    sd = state_dict_from_jax({"decoder": {"norm_out": norm, "conv_out": conv}})
    tnorm = (t(sd["decoder.norm_out.norm.weight"]), t(sd["decoder.norm_out.norm.bias"]))
    tconv_ = (t(sd["decoder.conv_out.conv.weight"]), t(sd["decoder.conv_out.conv.bias"]))
    close(decoder_tail_rgb_plain(t(x), tnorm, tconv_, mode), want)
    # the kernel's walk: per time tap j, dy, dx, the activated frame t-2+j
    close(scheme_d(t(x), tnorm, tconv_, mode), want)


def scheme_d(x, norm, conv, mode, ln=ln_silu_f32):
    """Kernel D in f32: the f32 activation's pieces, then the conv's six
    products against the weight pieces the kernel reads
    (tail_operands_f32: row ``9j + 3dx + co`` of ``[piece, dy]``), each in
    f32, per time tap j, dy and dx over the activated frame t-2+j."""
    op = tail_operands_f32(*conv, *norm)
    pa = split(F.pad(ln(x, *norm), (0, 0, 1, 1, 1, 1))).float()
    b, tt, h, w, _ = x.shape
    out = torch.zeros(b, tt, h, w, 3) + op["bias"]
    for ia, jw in PRODUCTS:
        for j in range(3):
            for f in range(tt):
                src = f - 2 + j
                if src < 0:
                    if mode == "zero":
                        continue
                    src = 0
                for dy in range(3):
                    for dx in range(3):
                        wk = op["w"][jw, dy, 9 * j + 3 * dx:9 * j + 3 * dx + 3].float().t()
                        out[:, f] += pa[ia, :, src, dy:dy + h, dx:dx + w] @ wk
    return out


# Rows whose mean is large beside their spread: E[x^2] - mean^2 loses the
# variance's digits in f32 (about 1e-4 of the activation at this mean), the
# two-pass statistics of the f32 row passes keep them. The residual
# blocks' outputs are held less x, the branch the offset would otherwise
# dwarf; F's new caches and D's output are held as they are. The reference
# is the JAX kernel with its exact LayerNorm + SiLU (silu_fast=False: the
# mean, then the mean of squared deviations).
ROW_MEAN = 50.0


def _mean_case(kernel, ln):
    """[(got, want)] of ``kernel`` on rows offset by ROW_MEAN, ``got`` from
    the scheme with ``ln`` and, where ``ln`` is the kernels', from the plain
    version too."""
    rng = np.random.RandomState(4)
    plain = ln is ln_silu_f32
    with torch.no_grad():
        if kernel == "A":
            x = (rng.randn(2, 32, 8, 32) + ROW_MEAN).astype(np.float32)
            jm = JB.ResnetBlockSpatial(32, norm_type="layernorm")
            p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[None]))["params"], rng)
            want = np.asarray(fused_spatial_resblock_v2(jnp.asarray(x), p, interpret=True,
                                                        silu_fast=False)) - x
            tm = load_port(TB.ResnetBlockSpatial(32, 32), p, ("encoder", "down_0_block_0"),
                           "encoder.down.0.block.0.")
            args = ((tm.norm1.norm.weight, tm.norm1.norm.bias),
                    (tm.conv1.weight, tm.conv1.bias),
                    (tm.norm2.norm.weight, tm.norm2.norm.bias),
                    (tm.conv2.weight, tm.conv2.bias), None)
            got = [scheme_a(t(x), *args, ln=ln)]
            if plain:
                got.append(fused_spatial_resblock_plain(t(x), *args))
            return [(g - t(x), want) for g in got]
        if kernel == "D":
            c = 32
            x = (rng.randn(1, 5, 16, 24, c) * 0.5 + ROW_MEAN).astype(np.float32)
            norm = {"scale": 1 + 0.2 * rng.randn(c).astype(np.float32),
                    "bias": 0.2 * rng.randn(c).astype(np.float32)}
            conv = {"kernel": 0.05 * rng.randn(3, 3, 3, c, 3).astype(np.float32),
                    "bias": 0.1 * rng.randn(3).astype(np.float32)}
            want = j_tail(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, norm),
                          jax.tree_util.tree_map(jnp.asarray, conv), "replicate",
                          interpret=True, silu_fast=False)
            sd = state_dict_from_jax({"decoder": {"norm_out": norm, "conv_out": conv}})
            tnorm = (t(sd["decoder.norm_out.norm.weight"]), t(sd["decoder.norm_out.norm.bias"]))
            tconv_ = (t(sd["decoder.conv_out.conv.weight"]), t(sd["decoder.conv_out.conv.bias"]))
            got = [scheme_d(t(x), tnorm, tconv_, "replicate", ln=ln)]
            if plain:
                got.append(decoder_tail_rgb_plain(t(x), tnorm, tconv_, "replicate"))
            return [(g, want) for g in got]
        b, h, w, c = 1, 8, 8, 128
        x = (rng.randn(b, 5, h, w, c) + ROW_MEAN).astype(np.float32)
        jm = JB.ResnetBlockTemporal(c, causal=True, norm_type="layernorm",
                                    first_pad_mode="replicate", cache_offset=1)
        p = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
        tm = load_port(TB.ResnetBlockTemporal(c, c, first_pad_mode="replicate", cache_offset=1),
                       p, ("decoder", "up_temporal_1_block_0"), "decoder.up_temporal.1.block.0.")
        args = ((tm.norm1.norm.weight, tm.norm1.norm.bias),
                (tm.conv1.conv.weight, tm.conv1.conv.bias),
                (tm.norm2.norm.weight, tm.norm2.norm.bias),
                (tm.conv2.conv.weight, tm.conv2.conv.bias))
        if kernel == "B":
            want = np.asarray(j_temporal(jnp.asarray(x), p, "replicate", interpret=True,
                                         silu_fast=False)) - x
            got = [scheme_b(t(x), *args, "replicate", ln=ln)]
            if plain:
                got.append(fused_temporal_resblock_plain(t(x), *args, "replicate"))
            return [(g - t(x), want) for g in got]
        assert kernel == "F"
        z = jnp.zeros((b, 2, h, w, c), jnp.float32)
        jy, jc1, jc2 = j_stream(jnp.asarray(x), p, z, z, first_chunk=True, offset=1,
                                interpret=True, silu_fast=False)
        outs = [scheme_f(t(x), *args, None, None, True, 1, ln=ln)]
        if plain:
            outs.append(fused_temporal_resblock_stream_plain(t(x), *args, None, None, True, 1))
        return [pair for y, c1, c2 in outs
                for pair in ((y - t(x), np.asarray(jy) - x), (c1, jc1), (c2, jc2))]


@pytest.mark.parametrize("kernel", ["A", "B", "F", "D"])
def test_f32_statistics_at_a_large_row_mean(kernel):
    """The f32 row passes' two-pass statistics (ln_silu_f32) hold the
    kernel's arithmetic and its plain version to JAX's exact kernel at REL
    on rows of mean ROW_MEAN; the one-pass statistics (ln_silu_fast) miss
    it on the same rows, so the case sees the difference."""
    for got, want in _mean_case(kernel, ln_silu_f32):
        close(got, want)
    assert max(rel_l2(got, want) for got, want in _mean_case(kernel, ln_silu_fast)) > REL


# -- the engine's default and the refusals ---------------------------------------

@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.float32, True), ("cuda", torch.bfloat16, True),
    ("cuda", torch.float16, False), ("cpu", torch.float32, False),
    ("cpu", torch.bfloat16, False), ("meta", torch.float32, False)])
def test_fused_default(device, dtype, want):
    """On for a CUDA device in bf16 or f32 (JAX's default engine runs its
    kernels in f32 on its chip); off elsewhere unless asked for."""
    assert fused_default(torch.device(device), dtype) is want
    assert fused_default(torch.device(device), dtype, False) is False
    if device != "cuda" or dtype != torch.float16:
        assert fused_default(torch.device(device), dtype, True) is True


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_fused_true_refuses_other_dtypes_on_the_card(dtype):
    with pytest.raises(ValueError, match="bf16 or f32"):
        fused_default(torch.device("cuda"), dtype, True)


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _args(name, dt):
    c = 128
    if name == "fused_spatial_resblock":
        return (_m(1, 8, 8, c, dtype=dt), (_m(c), _m(c)), (_m(c, c, 3, 3), _m(c)),
                (_m(c), _m(c)), (_m(c, c, 3, 3), _m(c)), None)
    if name == "fused_temporal_resblock":
        return (_m(1, 2, 8, 8, c, dtype=dt), (_m(c), _m(c)), (_m(c, c, 3), _m(c)),
                (_m(c), _m(c)), (_m(c, c, 3), _m(c)), "zero")
    if name == "fused_temporal_resblock_stream":
        return (_m(1, 2, 8, 8, c, dtype=dt), (_m(c), _m(c)), (_m(c, c, 3), _m(c)),
                (_m(c), _m(c)), (_m(c, c, 3), _m(c)), None, None, True, 1)
    if name == "parity_up2x_fused":
        return (_m(1, 2, 8, 8, c, dtype=dt), _m(c, c, 3, 3, 3), _m(c), _m(1), "zero")
    if name == "subpixel_interleave":
        return tuple(_m(1, 8, 8, c, dtype=dt) for _ in range(4)) + (_m(c),)
    if name in ("decoder_tail_rgb", "decoder_tail_rgb_taps"):
        return (_m(1, 4, 8, 8, c, dtype=dt), (_m(c), _m(c)), (_m(3, c, 3, 3, 3), _m(3)), "zero")
    if name == "subpixel_interleave_z":
        return (_m(1, 9, 9, 4 * c, dtype=dt), _m(c))
    if name == "parity_blend_interleave":
        return (_m(1, 2, 8, 8, c, dtype=dt), _m(1, 2, 8, 8, 2 * c, dtype=dt),
                _m(1, 2, 8, 8, 2 * c, dtype=dt), _m(c), _m(1), "zero")
    if name == "temporal_linear_blend":
        return (_m(1, 2, 8, 8, c, dtype=dt), _m(1, 2, 8, 8, 3 * c, dtype=dt), _m(c), _m(1), 1)
    assert name == "parity_blend_interleave4"
    return (_m(1, 2, 8, 8, c, dtype=dt), _m(1, 2, 8, 8, 4 * c, dtype=dt), _m(c), _m(1), "zero")


F32_KERNELS = ("fused_spatial_resblock", "fused_temporal_resblock",
               "fused_temporal_resblock_stream", "parity_up2x_fused", "subpixel_interleave",
               "decoder_tail_rgb", "parity_blend_interleave", "parity_blend_interleave4",
               "subpixel_interleave_z", "decoder_tail_rgb_taps", "temporal_linear_blend")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("name", F32_KERNELS)
def test_wrappers_refuse_other_dtypes(name, dtype):
    """Off the CPU, the eleven serving kernels (A-I, D', the trilinear
    upsample's blend) take bf16 or f32 and
    raise for any other dtype before they look at the device; nothing is
    launched, no plain version runs."""
    K.reset_counts()
    with pytest.raises(ValueError, match="bf16 or f32"):
        K.WRAPPERS[name](*_args(name, dtype))
    assert K.counts("calls")[name] == 1 and K.counts()[name] == 0


@pytest.mark.parametrize("name", F32_KERNELS)
def test_wrappers_take_f32(name):
    """An f32 tensor off the CPU passes the ten serving kernels' dtype and
    plan checks and reaches the device check (the meta device is not a
    card): an f32 request reaches a kernel in every form."""
    K.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.WRAPPERS[name](*_args(name, torch.float32))
    assert K.counts()[name] == 0


# -- the f32 operands ---------------------------------------------------------------

def _pieces_hold(wp, wf):
    """wp [Cout, 3K] bf16 pieces of wf [Cout, K] f32."""
    k = wf.shape[1]
    assert wp.dtype == torch.bfloat16 and wp.shape == (wf.shape[0], PIECES * k)
    assert wp.is_contiguous()
    back = sum(wp[:, q * k:(q + 1) * k].double() for q in range(PIECES))
    assert ((back - wf.double()).abs() <= 2.0 ** -24 * wf.double().abs()).all()
    assert torch.equal(wp[:, :k], wf.to(torch.bfloat16))


def test_f32_operand_layouts():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    cin, c = 64, 128
    w1, w2, wn = r(c, cin, 3, 3), r(c, c, 3, 3), r(c, cin, 1, 1)
    op = spatial_operands(w1, r(cin), r(cin), r(c), r(c), r(c), w2, r(c), wn, r(c), split=True)
    _pieces_hold(op["w1"], w1.permute(0, 2, 3, 1).reshape(c, -1))
    _pieces_hold(op["w2"], torch.cat([w2.permute(0, 2, 3, 1).reshape(c, -1),
                                      wn[:, :, 0, 0]], dim=1))
    assert op["bias2"].dtype == torch.float32
    wt1, wt2 = r(c, c, 3), r(c, c, 3)
    op = temporal_operands(wt1, r(c), r(c), r(c), r(c), r(c), wt2, r(c), split=True)
    _pieces_hold(op["w1"], kmajor_weight(wt1, torch.float32))
    _pieces_hold(op["w2"], kmajor_weight(wt2, torch.float32))
    we = r(c, c, 3, 3, 3) * 0.1
    op, op16 = parity_operands_f32(we, r(c)), parity_operands(we, r(c))
    assert op["w"].shape == (2 * c, PIECES * 18 * c)
    # the first piece is the bf16 operand of the bf16 kernel
    assert torch.equal(op["w"][:, :18 * c], op16["w"])
    wd = r(3, c, 3, 3, 3)
    op, op16 = tail_operands_f32(wd, r(3), r(c), r(c)), tail_operands(wd, r(3), r(c), r(c))
    assert op["w"].shape == (PIECES, 3, plan.TAIL_BN, c) and op["w"].dtype == torch.bfloat16
    assert op["w"].is_contiguous()
    for j, dy, dx, co in ((0, 0, 0, 0), (2, 1, 2, 1), (1, 2, 1, 2)):
        pieces = op["w"][:, dy, 9 * j + 3 * dx + co]
        back = sum(p.double() for p in pieces)
        want = wd[co, :, j, dy, dx].double()
        assert ((back - want).abs() <= 2.0 ** -24 * want.abs()).all()
    assert (op["w"][:, :, plan.TAIL_COLS:] == 0).all()
    # the first piece is the bf16 tail's operand
    assert torch.equal(op["w"][0], op16["w"])
