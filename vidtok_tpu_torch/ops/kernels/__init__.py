"""Hand-written Hopper kernels of the serving path and their plain forms.

Each wrapper runs its plain PyTorch version for a CPU tensor and its CUDA
kernel for a CUDA tensor (or raises). It keeps two counters: ``calls``
(every call) and ``launches`` (calls that launched the kernel).
"""

from .decoder_tail import decoder_tail_rgb
from .fused_spatial import fused_spatial_resblock
from .fused_temporal import (fused_temporal_resblock,
                             fused_temporal_resblock_stream)
from .parity_upsample import parity_up2x_fused
from .subpixel import subpixel_interleave

WRAPPERS = {
    "fused_spatial_resblock": fused_spatial_resblock,
    "fused_temporal_resblock": fused_temporal_resblock,
    "subpixel_interleave": subpixel_interleave,
    "decoder_tail_rgb": decoder_tail_rgb,
    "parity_up2x_fused": parity_up2x_fused,
    "fused_temporal_resblock_stream": fused_temporal_resblock_stream,
}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.calls = 0
        fn.launches = 0


def counts(kind: str = "launches") -> dict:
    """{wrapper name: count}; ``kind`` is ``calls`` or ``launches``."""
    return {name: getattr(fn, kind) for name, fn in WRAPPERS.items()}
