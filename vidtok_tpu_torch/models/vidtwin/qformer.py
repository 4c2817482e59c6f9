"""VidTwin's Q-Former (``vidtok_tpu/models/vidtwin/qformer.py``; reference
vidtwin/modules/qformer.py, a vendored HF ``Blip2QFormer`` behind
``MyQformerInterface``): learned query tokens through BERT-style post-LN
layers, self-attention in every layer and cross-attention into the
encoder's states in layers 0, 2, 4, ... (``cross_attention_frequency`` 2).

Affine LayerNorms with eps 1e-12, exact GELU, attention by
``F.scaled_dot_product_attention`` in the model's dtype (scale
``1/sqrt(head_dim)``). Module names are HF's
(``temporal_qformer.qformer.encoder.layer.0.crossattention.attention.key``),
so the reference state dict loads as it is; the text branch's
``intermediate`` / ``output`` FFN that HF builds beside the query one never
runs here and is not built (the checkpoint reader drops its keys).
``QFormerInterface.forward`` runs under the span ``vt.model.qformer``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.profiling import span
from .st_transformer import LayerNorm, Linear, init_, reset_linear_

EPS = 1e-12


class QKV(nn.Module):
    def __init__(self, hidden: int, kv_hidden: int):
        super().__init__()
        self.query = Linear(hidden, hidden)
        self.key = Linear(kv_hidden, hidden)
        self.value = Linear(kv_hidden, hidden)


class Dense(nn.Module):
    """HF's ``dense`` (+ ``LayerNorm``) container."""

    def __init__(self, d_in: int, d_out: int, norm: bool):
        super().__init__()
        self.dense = Linear(d_in, d_out)
        if norm:
            self.LayerNorm = LayerNorm(d_out, eps=EPS)


class BertAttention(nn.Module):
    """Post-LN attention: ``LN(dense(attn(x, kv)) + x)``; q from ``x``, k
    and v from ``kv`` (cross-attention) or ``x``."""

    def __init__(self, hidden: int, num_heads: int, kv_hidden: int):
        super().__init__()
        self.num_heads = num_heads
        self.attention = QKV(hidden, kv_hidden)
        self.output = Dense(hidden, hidden, norm=True)

    def forward(self, x, kv=None):
        kv = x if kv is None else kv
        a = self.attention
        b, nq, c = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(b, t.shape[1], h, c // h).transpose(1, 2)

        ctx = F.scaled_dot_product_attention(heads(a.query(x)), heads(a.key(kv)),
                                             heads(a.value(kv)))
        out = self.output.dense(ctx.transpose(1, 2).reshape(b, nq, c))
        return self.output.LayerNorm(out + x)


class QFormerLayer(nn.Module):
    def __init__(self, hidden: int, num_heads: int, intermediate: int,
                 encoder_hidden: int, has_cross_attention: bool):
        super().__init__()
        self.attention = BertAttention(hidden, num_heads, hidden)
        self.crossattention = (BertAttention(hidden, num_heads, encoder_hidden)
                               if has_cross_attention else None)
        self.intermediate_query = Dense(hidden, intermediate, norm=False)
        self.output_query = Dense(intermediate, hidden, norm=True)

    def forward(self, x, encoder_states):
        x = self.attention(x)
        if self.crossattention is not None:
            x = self.crossattention(x, encoder_states)
        h = F.gelu(self.intermediate_query.dense(x))
        out = self.output_query
        return out.LayerNorm(out.dense(h) + x)


class QFormerEncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class QFormerModel(nn.Module):
    def __init__(self, hidden: int, num_layers: int, num_heads: int, intermediate: int,
                 encoder_hidden: int, cross_attention_frequency: int):
        super().__init__()
        self.layernorm = LayerNorm(hidden, eps=EPS)
        self.encoder = QFormerEncoder(
            QFormerLayer(hidden, num_heads, intermediate, encoder_hidden,
                         i % cross_attention_frequency == 0)
            for i in range(num_layers))

    def forward(self, x, encoder_states):
        x = self.layernorm(x)
        for layer in self.encoder.layer:
            x = layer(x, encoder_states)
        return x


class QFormerInterface(nn.Module):
    """``forward(encoder_hidden_states [B, L, enc_C]) -> [B, num_query, C]``
    (reference ``MyQformerInterface``)."""

    def __init__(self, num_query_tokens: int = 3, query_hidden_size: int = 64,
                 encoder_hidden_size: int = 768, num_hidden_layers: int = 6,
                 intermediate_size: int = 768, num_attention_heads: int = 8,
                 cross_attention_frequency: int = 2):
        super().__init__()
        self.query_hidden_size = query_hidden_size
        self.query_embeds = nn.Parameter(torch.empty(num_query_tokens, query_hidden_size))
        self.qformer = QFormerModel(query_hidden_size, num_hidden_layers,
                                    num_attention_heads, intermediate_size,
                                    encoder_hidden_size, cross_attention_frequency)

    def reset_params(self, generator=None):
        """flax's defaults: queries N(0, 1), kernels lecun normal, biases 0,
        norms 1 and 0."""
        init_(self.query_embeds, "normal", generator)
        for m in self.qformer.modules():
            if isinstance(m, Linear):
                reset_linear_(m, generator, "lecun")
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, encoder_hidden_states):
        with span("vt.model.qformer"):
            q = self.query_embeds.to(encoder_hidden_states.dtype)
            x = q[None].expand(encoder_hidden_states.shape[0], -1, -1)
            return self.qformer(x, encoder_hidden_states)
