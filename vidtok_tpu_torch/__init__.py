"""vidtok_tpu_torch: the VidTok tokenizer in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

It sits beside ``vidtok_tpu`` (JAX), which stays the reference. Ported so
far: the non-streaming serving path of the causal v1.0 and v1.1
tokenizers, KL and FSQ (no projections), with the five Pallas kernels of
that path as CUDA kernels (``ops/kernels``, ``csrc``). Imports torch and
numpy only.

    from vidtok_tpu_torch import load_model_from_config
    tok = load_model_from_config(cfg, device="cuda", compute_dtype=torch.bfloat16)
    z, xrec, reg_log = tok(x)            # x: [B, 3, T, H, W] in [-1, 1]
"""

from .models.autoencoder import (TokenizerCore, VideoTokenizer,
                                 build_core_from_config)

__all__ = ["load_model_from_config", "VideoTokenizer", "TokenizerCore",
           "build_core_from_config"]


def load_model_from_config(config, **kwargs) -> VideoTokenizer:
    """Build a tokenizer engine from a resolved config dict or a YAML path
    (a path needs PyYAML and ``vidtok_tpu.config``). ``kwargs`` go to
    :meth:`VideoTokenizer.from_config` (seed, device, compute_dtype, fused)."""
    return VideoTokenizer.from_config(config, **kwargs)
