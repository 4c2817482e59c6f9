"""VidTwin weights between the JAX package's parameter tree and the
reference torch layout this package's modules use.

:func:`vidtwin_state_dict_from_jax` inverts
``vidtok_tpu/models/vidtwin/convert.py``'s ``convert_vidtwin_state_dict``:
Dense kernels ``[in, out]`` become Linear ``[out, in]``, Conv HWIO becomes
OIHW, the patch embedding's DHWIO becomes OIDHW, the token mix's
``[out, in]`` becomes a Conv1d ``[out, in, 1]``, ``scale`` becomes
``weight``, and module names regain the reference's (``content_down_0``
-> ``content_downsample_blocks.0``, ``qformer/layer_2/output`` ->
``temporal_qformer.qformer.encoder.layer.2.output_query.dense``).

:data:`DROPPED` names the reference keys that JAX's converter drops and
that no module here holds: the loss and EMA sections, the regularizer,
the sincos buffers, the encoder's unused final layer and the decoder's
unused patch embedding, and the Q-Former's text-branch FFN. It needs numpy
only.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

DROPPED = re.compile(
    r"^(loss|model_ema|regularization)\."
    r"|\.(pos_embed|pos_embed_temporal)$"
    r"|^encoder\.final_layer\.|^decoder\.x_embedder\."
    r"|^temporal_qformer\.qformer\.encoder\.layer\.\d+\.(intermediate|output)\.")

_QF = "temporal_qformer.qformer."
# JAX module name -> (reference prefix, layout of its kernel)
_GLUE = [
    (r"conv_in", "conv_in", "conv"),
    (r"content_down_(\d+)", lambda i: f"content_downsample_blocks.{2 * i}", "conv"),
    (r"content_up_(\d+)", lambda i: f"content_upsample_blocks.{3 * i}", "conv"),
    (r"bottle_down", "bottle_down", "conv"),
    (r"bottle_up", "bottle_up", "conv"),
    (r"conv_out", "conv_out", "conv"),
    (r"cont_emb_dense", "cont_emb.0", "linear"),
    (r"cont_emb_mix", "cont_emb.2", "mix"),
    (r"motion_emb_(\d)", lambda i: f"motion_emb.{2 * (i - 1)}", "linear"),
    (r"motion_head", "motion_head", "conv"),
    (r"motion_down_(\d+)", lambda i: f"downsample_motion_module.{2 * i}", "conv"),
    (r"up_motion_(\d)", lambda i: f"up_motion.{2 * (i - 1)}", "linear"),
]


def _weight(k, kind: str) -> np.ndarray:
    k = np.asarray(k)
    if kind == "linear":
        w = k.T
    elif kind == "conv":            # HWIO -> OIHW
        w = k.transpose(3, 2, 0, 1)
    elif kind == "conv3d":          # DHWIO -> OIDHW
        w = k.transpose(4, 3, 0, 1, 2)
    elif kind == "mix":             # [out, in] -> Conv1d [out, in, 1]
        w = k[..., None]
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(w)


def _put(out: dict, prefix: str, p: dict, kind: str = "linear") -> None:
    """A Dense / Conv (``kernel``, ``bias``) or a LayerNorm (``scale``,
    ``bias``) at ``prefix``."""
    if "kernel" in p:
        out[prefix + ".weight"] = _weight(p["kernel"], kind)
    else:
        out[prefix + ".weight"] = np.asarray(p["scale"])
    out[prefix + ".bias"] = np.asarray(p["bias"])


def _stt(root: str, tree: dict, out: dict) -> None:
    for name, sub in tree.items():
        if name == "x_embedder":
            _put(out, f"{root}.x_embedder.proj", sub["proj"], "conv3d")
        elif name == "final_layer":
            out[f"{root}.final_layer.scale_shift_table"] = np.asarray(sub["scale_shift_table"])
            _put(out, f"{root}.final_layer.linear", sub["linear"])
        elif name.startswith("blocks_"):
            base = f"{root}.blocks.{name[len('blocks_'):]}"
            for part, leaf in sub.items():
                if part == "scale_shift_table":
                    out[f"{base}.scale_shift_table"] = np.asarray(leaf)
                else:  # attn / attn_temp (qkv, proj), mlp (fc1, fc2)
                    for lin, p in leaf.items():
                        _put(out, f"{base}.{part}.{lin}", p)
        else:
            raise KeyError(f"unexpected JAX leaf {root}/{name}")


def _qformer(tree: dict, out: dict) -> None:
    out["temporal_qformer.query_embeds"] = np.asarray(tree["query_embeds"])
    _put(out, _QF + "layernorm", tree["layernorm"])
    for name, layer in tree.items():
        if not name.startswith("layer_"):
            continue
        base = f"{_QF}encoder.layer.{name[len('layer_'):]}"
        for part, p in layer.items():
            if part in ("attention", "crossattention"):
                for proj in ("query", "key", "value"):
                    _put(out, f"{base}.{part}.attention.{proj}", p[proj])
                _put(out, f"{base}.{part}.output.dense", p["out_dense"])
                _put(out, f"{base}.{part}.output.LayerNorm", p["out_norm"])
            elif part == "intermediate":
                _put(out, f"{base}.intermediate_query.dense", p)
            elif part == "output":
                _put(out, f"{base}.output_query.dense", p)
            elif part == "output_norm":
                _put(out, f"{base}.output_query.LayerNorm", p)
            else:
                raise KeyError(f"unexpected JAX leaf qformer/{name}/{part}")


def vidtwin_state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A JAX ``VidTwinVAE`` parameter tree (numpy leaves) -> a flat state
    dict in the reference's keys and layouts."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        if name in ("encoder", "decoder"):
            _stt(name, sub, out)
            continue
        if name == "qformer":
            _qformer(sub, out)
            continue
        for pat, prefix, kind in _GLUE:
            m = re.fullmatch(pat, name)
            if m:
                key = prefix(int(m.group(1))) if callable(prefix) else prefix
                _put(out, key, sub, kind)
                break
        else:
            raise KeyError(f"unexpected JAX module {name}")
    return out
