"""vidtok_tpu_torch: the VidTok tokenizer in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

It sits beside ``vidtok_tpu`` (JAX), which stays the reference. Ported:
the serving path of every VidTok tokenizer config (causal v1.0 and v1.1,
non-causal; KL and FSQ without projections; layernorm and groupnorm), the
v1.1 tiled (chunked, streaming) inference, checkpoint loading and saving
(``utils/checkpoint.py``), the quality metrics, LPIPS, the video data
path and the three serving CLIs (``scripts``), and the fourteen Pallas
kernels of the JAX package as CUDA kernels (``ops/kernels``, ``csrc``,
``tools``), four of them alternative forms of the decoder's call sites
(``KernelForms``).
Imports torch and numpy only (and PyYAML for a YAML config, safetensors
for such a file, OpenCV where a video is read without the native
library or written).

    from vidtok_tpu_torch import load_model_from_config
    tok = load_model_from_config(cfg, ckpt=None, compute_dtype=torch.bfloat16)
    z, xrec, reg_log = tok(x)            # x: [B, 3, T, H, W] in [-1, 1]
    tok.use_tiling = True; tok.use_overlap = True   # v1.1: chunk by chunk
    tok.forms = KernelForms(parity="merged", subpixel="merged", tail="taps")
    tok.save("model.ckpt")
"""

from .models.autoencoder import (TokenizerCore, VideoTokenizer,
                                 build_core_from_config)
from .ops.kernels import KernelForms

__all__ = ["load_model_from_config", "VideoTokenizer", "TokenizerCore",
           "build_core_from_config", "KernelForms"]


def load_model_from_config(config, ckpt=None, device="cuda", **kwargs) -> VideoTokenizer:
    """Build a tokenizer engine from a config dict or a YAML path (a path
    needs PyYAML) on ``device``, the card unless the caller names the CPU;
    without CUDA it raises. Weights from ``ckpt``, else the config's
    ``ckpt_path``, else random. ``kwargs`` go to
    :meth:`VideoTokenizer.from_config` (seed, compute_dtype, fused, forms)."""
    return VideoTokenizer.from_config(config, ckpt=ckpt, device=device, **kwargs)
