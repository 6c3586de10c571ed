"""The dense DETR encoder of the ``trans`` BEV fusion, port of
``mvdetr_tpu/models/transformer.py``.

Contract (the JAX module's): post-norm residual layers with a ReLU FFN; the
positional embedding is added to the queries and keys only. The attention
is Flax's ``MultiHeadDotProductAttention`` written out: q, k and v
projections, q divided by ``sqrt(head_dim)`` before ``q @ k^T``, softmax in
f32, dropout on the attention weights with one mask shared by the batch and
the heads (Flax's ``broadcast_dropout``), ``@ v`` and the output projection.
It is explicit operations, not a fused attention, so a train step repeats
bitwise on the card.

The JAX modules have no ``dtype`` field, so Flax promotes a bf16 input
against the f32 parameters and the whole encoder computes in f32; so does
this one, whatever the model's compute dtype.

Parameter names are the reference checkpoint's (``torch.nn.MultiheadAttention``
and ``TransformerEncoderLayer``): ``self_attn.in_proj_weight`` ``[3C, C]``
(rows q; k; v), ``self_attn.in_proj_bias``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdetr_tpu_torch.models.layers import Dropout, LayerNorm, Linear, lecun_normal_


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int = 128, nhead: int = 8, dropout: float = 0.1, generator=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        with torch.no_grad():  # Flax's query/key/value kernels: lecun_normal over fan_in d_model each
            for part in self.in_proj_weight.chunk(3):
                lecun_normal_(part, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, init="lecun", generator=generator)
        self.dropout = Dropout(dropout, broadcast_dims=(0, 1))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``q/k/v [B, T, C]`` -> ``[B, T, C]`` in f32."""
        b, t, c = q.shape
        heads, dh = self.nhead, c // self.nhead
        w, bias = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        qp, kp, vp = (F.linear(x.float(), wi, bi).view(b, x.shape[1], heads, dh)
                      for x, wi, bi in zip((q, k, v), w, bias))
        qp = qp / math.sqrt(dh)
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qp, kp), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", self.dropout(attn), vp)
        return self.out_proj(out.reshape(b, t, c))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 128, nhead: int = 8, dim_feedforward: int = 512, dropout: float = 0.1,
                 generator=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, generator)
        self.dropout1 = Dropout(dropout)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, dim_feedforward, init="lecun", generator=generator)
        self.dropout = Dropout(dropout)
        self.linear2 = Linear(dim_feedforward, d_model, init="lecun", generator=generator)
        self.dropout2 = Dropout(dropout)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        q = src if pos is None else src + pos
        src = self.norm1(src + self.dropout1(self.self_attn(q, q, src)))
        y = self.linear2(self.dropout(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout2(y))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int = 3, d_model: int = 128, nhead: int = 8, dim_feedforward: int = 512,
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, generator)
                                    for _ in range(num_layers))

    def forward(self, src: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        """``src [B, T, C]`` and ``pos`` broadcastable to it -> ``[B, T, C]`` f32."""
        for layer in self.layers:
            src = layer(src, pos)
        return src
