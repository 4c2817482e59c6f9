"""vidtok_tpu_torch: the VidTok tokenizer in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

It sits beside ``vidtok_tpu`` (JAX), which stays the reference. Ported so
far: the serving path of the causal v1.0 and v1.1 tokenizers, KL and FSQ
(no projections), and the v1.1 tiled (chunked, streaming) inference, with
the ten Pallas kernels of those paths as CUDA kernels (``ops/kernels``,
``csrc``), four of them alternative forms of the decoder's call sites
(``KernelForms``). Imports torch and numpy only (and PyYAML for a YAML config).

    from vidtok_tpu_torch import load_model_from_config
    tok = load_model_from_config(cfg, compute_dtype=torch.bfloat16)  # on the card
    z, xrec, reg_log = tok(x)            # x: [B, 3, T, H, W] in [-1, 1]
    tok.use_tiling = True; tok.use_overlap = True   # v1.1: chunk by chunk
    tok.forms = KernelForms(parity="merged", subpixel="merged", tail="taps")
"""

from .models.autoencoder import (TokenizerCore, VideoTokenizer,
                                 build_core_from_config)
from .ops.kernels import KernelForms

__all__ = ["load_model_from_config", "VideoTokenizer", "TokenizerCore",
           "build_core_from_config", "KernelForms"]


def load_model_from_config(config, device="cuda", **kwargs) -> VideoTokenizer:
    """Build a tokenizer engine from a config dict or a YAML path (a path
    needs PyYAML) on ``device``, the card unless the caller names the CPU;
    without CUDA it raises. ``kwargs`` go to
    :meth:`VideoTokenizer.from_config` (seed, compute_dtype, fused, forms)."""
    return VideoTokenizer.from_config(config, device=device, **kwargs)
