"""Hand-written Hopper kernels of the serving path and their plain forms.

Each wrapper runs its plain PyTorch version for a CPU tensor and its CUDA
kernel for a CUDA tensor (or raises), under the span ``vt.kernel.<wrapper
name>`` (``_lib.wrapper``). It keeps seven counters: ``calls`` (every
call), ``launches`` (calls that launched the kernel), ``builds``
(operand relayouts built because no cached one was served),
``conv_tiles`` / ``conv_blocks``, the output tiles and blocks of its wgmma
conv launches (A, B, E, F; 0 elsewhere), and ``base_frames`` /
``up_frames``, the input and output frames of the v1.1 trilinear temporal
upsample's blend (``temporal_linear_blend``, which reads the base convs
cuDNN takes of the input frames; 0 elsewhere). Every kernel takes bf16 or
f32 activations (f32: ``split.py``'s scheme in A, B, E and F) and raises
for another dtype, naming the kernel.

:class:`KernelForms` picks which kernel form runs at the decoder's call
sites that have more than one.
"""

from dataclasses import dataclass

from .decoder_tail import decoder_tail_rgb, decoder_tail_rgb_taps
from .fused_spatial import fused_spatial_resblock
from .fused_temporal import (fused_temporal_resblock,
                             fused_temporal_resblock_stream)
from .parity_upsample import parity_up2x_fused
from .subpixel import subpixel_interleave, subpixel_interleave_z
from .temporal_linear import temporal_linear_blend
from .upsample_epilogue import parity_blend_interleave, parity_blend_interleave4

WRAPPERS = {
    "fused_spatial_resblock": fused_spatial_resblock,
    "fused_temporal_resblock": fused_temporal_resblock,
    "subpixel_interleave": subpixel_interleave,
    "decoder_tail_rgb": decoder_tail_rgb,
    "parity_up2x_fused": parity_up2x_fused,
    "fused_temporal_resblock_stream": fused_temporal_resblock_stream,
    "parity_blend_interleave": parity_blend_interleave,
    "parity_blend_interleave4": parity_blend_interleave4,
    "subpixel_interleave_z": subpixel_interleave_z,
    "decoder_tail_rgb_taps": decoder_tail_rgb_taps,
    "temporal_linear_blend": temporal_linear_blend,
}

# field -> its values, the default (JAX's default) first
FORM_VALUES = {"parity": ("fused", "merged", "split"),
               "subpixel": ("split", "merged"),
               "tail": ("packed", "taps")}


@dataclass(frozen=True)
class KernelForms:
    """The kernel form of each decoder call site that has several, when
    ``fused`` is set (with ``fused`` off the plain path runs whatever this
    says). The JAX package picks these with environment switches read at
    import and with shapes that decline; here the caller names them, an
    unknown value raises, and a form that cannot run a shape raises.

    * ``parity``, the v1.0 (nearest) temporal upsample: ``fused`` kernel E;
      ``merged`` one C->4C conv + kernel H (JAX wherever E declines);
      ``split`` two C->2C convs + kernel G (``VIDTOK_PARITY_MERGED=0``).
    * ``subpixel``, the spatial upsample: ``split`` four parity convs +
      kernel C; ``merged`` one VALID 2x2 conv + kernel I
      (``VIDTOK_SUBPIXEL_MERGED=1``).
    * ``tail``, the decoder tail: ``packed`` kernel D; ``taps`` kernel D'
      (``VIDTOK_TAIL_TAP_PACK=0``).
    """

    parity: str = "fused"
    subpixel: str = "split"
    tail: str = "packed"

    def __post_init__(self):
        for field, values in FORM_VALUES.items():
            if getattr(self, field) not in values:
                raise ValueError(f"unknown {field} form {getattr(self, field)!r}; "
                                 f"one of {values}")


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.calls = fn.launches = fn.builds = fn.conv_tiles = fn.conv_blocks = 0
        fn.base_frames = fn.up_frames = 0


def counts(kind: str = "launches") -> dict:
    """{wrapper name: count}; ``kind`` is ``calls``, ``launches``,
    ``builds``, ``conv_tiles``, ``conv_blocks``, ``base_frames`` or
    ``up_frames``."""
    return {name: getattr(fn, kind) for name, fn in WRAPPERS.items()}
