"""VidTwin weights between the JAX package's parameter tree and the
reference torch layout this package's modules use.

:func:`vidtwin_state_dict_from_jax` inverts
``vidtok_tpu/models/vidtwin/convert.py``'s ``convert_vidtwin_state_dict``,
:func:`vidtwin_ablation_state_dict_from_jax` its
``convert_vidtwin_ablation_state_dict`` (the ablation ladder):
Dense kernels ``[in, out]`` become Linear ``[out, in]``, Conv HWIO becomes
OIHW, the patch embedding's DHWIO becomes OIDHW, the token mix's
``[out, in]`` becomes a Conv1d ``[out, in, 1]``, ``scale`` becomes
``weight``, and module names regain the reference's (``content_down_0``
-> ``content_downsample_blocks.0``, ``qformer/layer_2/output`` ->
``temporal_qformer.qformer.encoder.layer.2.output_query.dense``,
``height_qformer`` -> ``hight_qformer``, the reference's spelling).

:data:`DROPPED` names the reference keys that JAX's converter drops and
that no module here holds: the loss and EMA sections, the regularizer,
the sincos buffers, the encoder's unused final layer and the decoder's
unused patch embedding, and every Q-Former's text-branch FFN. It needs
numpy only.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

DROPPED = re.compile(
    r"^(loss|model_ema|regularization)\."
    r"|\.(pos_embed|pos_embed_temporal)$"
    r"|^encoder\.final_layer\.|^decoder\.x_embedder\."
    r"|^\w+_qformer\.qformer\.encoder\.layer\.\d+\.(intermediate|output)\.")

# JAX module name (``/`` between levels) -> (its reference prefix from the
# name's match, layout of its kernel)
_PYRAMID = [
    (r"conv_in|bottle_down|bottle_up|conv_out", lambda m: m[0], "conv"),
    (r"content_down_(\d+)", lambda m: f"content_downsample_blocks.{2 * int(m[1])}", "conv"),
    (r"content_up_(\d+)", lambda m: f"content_upsample_blocks.{3 * int(m[1])}", "conv"),
]
_GLUE = _PYRAMID + [
    (r"cont_emb_dense", lambda m: "cont_emb.0", "linear"),
    (r"cont_emb_mix", lambda m: "cont_emb.2", "mix"),
    (r"motion_emb_(\d)", lambda m: f"motion_emb.{2 * (int(m[1]) - 1)}", "linear"),
    (r"motion_head", lambda m: m[0], "conv"),
    (r"motion_down_(\d+)", lambda m: f"downsample_motion_module.{2 * int(m[1])}", "conv"),
    (r"up_motion_(\d)", lambda m: f"up_motion.{2 * (int(m[1]) - 1)}", "linear"),
]
# the ablation ladder (JAX ``convert.py:183-282``): EmbSeq heads as
# ``{name}/dense`` and ``{name}/mix`` (indices 0, 2), the six-element heads
# flat as ``{cont|spatial}_{dense_1|dense_2|mix}`` (0, 2, 4)
_ABLATION_GLUE = _PYRAMID + [
    (r"(\w+_emb)/dense", lambda m: f"{m[1]}.0", "linear"),
    (r"(\w+_emb)/mix", lambda m: f"{m[1]}.2", "mix"),
    (r"(cont|spatial)_dense_(\d)", lambda m: f"{m[1]}_emb.{2 * (int(m[2]) - 1)}", "linear"),
    (r"(cont|spatial)_mix", lambda m: f"{m[1]}_emb.4", "mix"),
    (r"pre_spatial_(\d)", lambda m: f"pre_spatial_qformer.{2 * (int(m[1]) - 1)}", "linear"),
    (r"pre_temporal_qformer", lambda m: "pre_temporal_qformer.0", "linear"),
    (r"down_channel_temp|up_channel_temp", lambda m: m[0], "linear"),
]
# JAX Q-Former root -> reference attribute
_QFORMERS = {"temporal_qformer": "temporal_qformer", "height_qformer": "hight_qformer",
             "width_qformer": "width_qformer", "space_qformer": "space_qformer"}


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


def _qformer(tree: dict, out: dict, root: str = "temporal_qformer") -> None:
    qf = f"{root}.qformer."
    out[f"{root}.query_embeds"] = np.asarray(tree["query_embeds"])
    _put(out, qf + "layernorm", tree["layernorm"])
    for name, layer in tree.items():
        if not name.startswith("layer_"):
            continue
        base = f"{qf}encoder.layer.{name[len('layer_'):]}"
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


def _glue(name: str, sub: dict, table, out: dict) -> None:
    """One glue module of JAX's tree (a Dense / Conv / TokenMix, or a head
    whose children are) into ``out`` by ``table``."""
    if "kernel" not in sub:
        for child, p in sub.items():
            _glue(f"{name}/{child}", p, table, out)
        return
    for pat, prefix, kind in table:
        m = re.fullmatch(pat, name)
        if m:
            _put(out, prefix(m), sub, kind)
            return
    raise KeyError(f"unexpected JAX module {name}")


def vidtwin_state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A JAX ``VidTwinVAE`` parameter tree (numpy leaves) -> a flat state
    dict in the reference's keys and layouts."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        if name in ("encoder", "decoder"):
            _stt(name, sub, out)
        elif name == "qformer":
            _qformer(sub, out)
        else:
            _glue(name, sub, _GLUE, out)
    return out


def vidtwin_ablation_state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A JAX ablation-ladder parameter tree (``VidTwinQformer``,
    ``VidTwinCompact``, ``VidTwinSym``; numpy leaves) -> a flat state dict
    in the reference's keys and layouts."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        if name in ("encoder", "decoder"):
            _stt(name, sub, out)
        elif name in _QFORMERS:
            _qformer(sub, out, _QFORMERS[name])
        else:
            _glue(name, sub, _ABLATION_GLUE, out)
    return out
