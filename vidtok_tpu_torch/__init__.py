"""vidtok_tpu_torch: the VidTok tokenizer in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

It sits beside ``vidtok_tpu`` (JAX), which stays the reference. Ported:
the serving path of every VidTok tokenizer config (causal v1.0 and v1.1,
non-causal; KL and FSQ, FSQ with its projections and codebooks; layernorm
and groupnorm; the resblocks' dropout in training), the
v1.1 tiled (chunked, streaming) inference, checkpoint loading and saving
(``utils/checkpoint.py``), the quality metrics, LPIPS, the video data
path and the three serving CLIs (``scripts``), the GAN training stack
(``train``: losses, discriminators, the trainer, train-state checkpoints,
data parallelism, the train CLI), VidTwin (``models/vidtwin``: the
structure/dynamics tokenizer and its ablation ladder, their weights,
engine, CLIs, schedules and trainer), the H-sharded forward
(``VideoTokenizer.forward_sharded`` over ``parallel/mesh.py``), the
profiling helpers (``utils/profiling.py``), and the fourteen Pallas
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
    cfg = merge_configs("configs/vidtok_kl_causal_488_16chn.yaml", overrides,
                        dotlist=["model.params.use_tiling=false"])
    twin = load_model_from_config("configs/vidtwin/vidtwin_structure_7_7_8_dynamics_7_8.yaml")
    u_s, u_dx, u_dy, reg_log = twin.encode(x)   # x: [B, 3, 16, 224, 224]
"""

from .config import load_config, merge_configs
from .models.autoencoder import (TokenizerCore, VideoTokenizer,
                                 build_core_from_config)
from .ops.kernels import KernelForms
from .registry import get_obj_from_str, instantiate_from_config, register

__all__ = ["register", "instantiate_from_config", "get_obj_from_str",
           "load_config", "merge_configs", "load_model_from_config",
           "VideoTokenizer", "TokenizerCore", "build_core_from_config",
           "KernelForms"]


def load_model_from_config(config, ckpt=None, device="cuda", **kwargs):
    """Build a tokenizer engine from a config dict or a YAML path (a path
    needs PyYAML) on ``device``, the card unless the caller names the CPU;
    without CUDA it raises. A VidTwin target gives a
    :class:`~.models.vidtwin.engine.VidTwinTokenizer` (weights from
    ``ckpt``, else random; ``kwargs``: seed, compute_dtype, full_pickle),
    any other a :class:`VideoTokenizer` (weights from ``ckpt``, else the
    config's ``ckpt_path``, else random; ``kwargs`` go to
    :meth:`VideoTokenizer.from_config`: seed, compute_dtype, fused, forms,
    full_pickle)."""
    cfg = load_config(config)
    target = str((cfg.get("model", cfg) or {}).get("target", ""))
    if "VidTwin" in target or "vidtwin" in target:
        from .models.vidtwin.engine import VidTwinTokenizer

        return VidTwinTokenizer.from_config(cfg, ckpt=ckpt, device=device, **kwargs)
    return VideoTokenizer.from_config(cfg, ckpt=ckpt, device=device, **kwargs)
