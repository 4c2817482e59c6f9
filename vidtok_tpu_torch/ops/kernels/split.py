"""The f32 scheme of the wgmma loop (``csrc/wgmma_conv.cuh``): bf16 splits
on its bf16 instruction.

Kernels A, B, E and F take f32 activations by splitting each f32 operand
into three bf16 pieces, ``x = hi + mid + lo`` (each piece the bf16 rounding
of what the pieces before it leave, the remainder exact in f32, so the
pieces hold x to 2^-24 of itself), and summing in the f32 accumulator the
six products whose pieces' orders add up to at most 2, :data:`PRODUCTS`,
in the order the loop runs them. The largest product left out, mid * lo,
is about 2^-26 of hi * hi.

:func:`split` is the split the row passes (``common.cuh``: ``split3``) and
the wrappers' weight operands make; :func:`kmajor_pieces` the weights'
layout; :func:`product_sum` the scheme's arithmetic in PyTorch, which the
CPU tests hold to the JAX kernels in f32.
"""

from __future__ import annotations

import torch

PIECES = 3
# (piece of the activation, piece of the weight) of each product, smallest
# first: wgmma_conv.cuh's kPieceA / kPieceW
PRODUCTS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))


def split(x, pieces: int = PIECES):
    """f32 ``x`` -> ``[pieces, *x.shape]`` bf16: piece k is the bf16
    rounding of x less the pieces before it."""
    r = x.float()
    out = []
    for _ in range(pieces):
        p = r.to(torch.bfloat16)
        out.append(p)
        r = r - p.float()
    return torch.stack(out)


def kmajor_pieces(w):
    """A K-major weight ``[Cout, K]`` -> its pieces side by side along K,
    ``[Cout, PIECES * K]`` bf16, contiguous: the f32 scheme's operand."""
    return torch.cat(list(split(w)), dim=1).contiguous()


def product_sum(fn, a, w):
    """``fn`` (bilinear in its two arguments, e.g. a conv of activations
    ``a`` by weight ``w``) under the f32 scheme: the sum over
    :data:`PRODUCTS` of ``fn`` of the pieces, each product in f32."""
    pa, pw = split(a), split(w)
    out = None
    for i, j in PRODUCTS:
        y = fn(pa[i].float(), pw[j].float())
        out = y if out is None else out + y
    return out
