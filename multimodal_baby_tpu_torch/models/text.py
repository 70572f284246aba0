"""Text encoder (counterpart of ``multimodal_baby_tpu/models/text.py``), in
all five of its modes:

- ``embedding``: the token embeddings;
- ``cbow``: the mean of the 2 ``crange`` neighbours' embeddings, by a prefix
  sum (spatial embeddings only);
- ``lstm``: a masked LSTM over the padded window (optionally conditioned on
  the image: ``captioning`` maps the image features to (h0, c0) through
  ``connector``; ``attention`` adds an additive attention over the feature
  map to each step's input, with an optional sigmoid gate);
- ``bilstm``: both directions, the backward one over each row reversed
  within its length; their per-step outputs averaged;
- ``transformer``: the token embeddings plus a positional embedding
  (learned, sinusoidal or none) through one post-norm transformer encoder
  layer (8 heads, feed-forward 2048, dropout 0.1 in training), PAD keys
  masked.

The port adds a sixth, ``clip`` (``build_text_encoder``): CLIP's causal
text tower and its projection (``models/clip.py::CLIPTextEncoder``), for
the CLIP trunk named by ``VisionConfig.cnn_model``, in the model's compute
dtype.

The flat embedding is the sum of the outputs over the whole padded window
divided by the true length (embedding, transformer; the reference's
semantics: padded query positions contribute to the sum), or the final
valid hidden state averaged over directions (LSTMs). ``dropout_i`` drops
the LSTMs' inputs (one mask per row and channel, shared over time);
``dropout_o`` drops every mode's per-step outputs the same way and, with a
fresh draw, the flat embedding. The dropouts draw from the generator passed
to ``forward``; none means deterministic, as in eval.

Parameter names follow the reference: ``embedding.weight``,
``lstm.{weight_ih_l0, weight_hh_l0, bias_ih_l0, bias_hh_l0}[_reverse]``,
``connector``, ``attention.*``, ``attention_gate_projection``,
``transformer_encoder.layers.0.*``, ``pos_embed`` (learned only,
``[25, 1, E]``).

``vocab_shard`` (``parallel/vocab.py``; None unless the mesh's model axis
has more than one rank) makes ``embedding.weight`` this rank's slice of
the vocab rows: a lookup then masks the ids outside the slice and sums
over the model group.

``fused_lstm`` selects the LSTM recurrence's kernel (K9,
``ops/lstm.py``): None is the JAX package's rule (K9 for windows of 64
steps or more), True K9 at every length, False never; see
``models/layers.py::use_fused_lstm``; it is a keyword of the constructor
and a validated attribute of a live encoder. The attention LSTM's
recurrence reads the attention at every step and is a plain loop, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.config import ModelConfig
from multimodal_baby_tpu_torch.core.constants import (
    MAX_LEN_UTTERANCE, PAD_TOKEN_ID)
from multimodal_baby_tpu_torch.models.attention import (
    AdditiveAttention, additive_attention)
from multimodal_baby_tpu_torch.models.clip import (
    CLIP_CONFIGS, CLIPTextEncoder, tower_configs)
from multimodal_baby_tpu_torch.models.layers import (
    LSTMCellParams, TorchLinear, TorchTransformerEncoderLayer,
    check_fused_lstm, dropout, length_mask, locked_dropout, lstm_gates,
    lstm_scan, lstm_step, padding_safe_embed, resolve_device, reverse_padded,
    sinusoidal_pos_embed)
from multimodal_baby_tpu_torch.parallel import vocab as vocab_parallel

_ARCHS = ("embedding", "cbow", "lstm", "bilstm", "transformer")
_POS_EMBEDS = ("no_pos_embed", "learned", "sinusoidal")

Tensor = torch.Tensor


def build_text_encoder(cfg: ModelConfig, image_feature_map_dim: int, *,
                       dtype: torch.dtype | None = None, device="cuda",
                       generator: torch.Generator | None = None,
                       fused_lstm: bool | None = None) -> nn.Module:
    """CVCL's text encoder: ``CLIPTextEncoder`` for ``"clip"`` (the text
    tower of the CLIP that ``cfg.vision.cnn_model`` names, computing in
    ``dtype``, its vocabulary ``cfg.vocab_size``), else ``TextEncoder``
    (which computes in f32, as the JAX package's does)."""
    if cfg.text.text_encoder != "clip":
        return TextEncoder(cfg, image_feature_map_dim, device=device,
                           generator=generator, fused_lstm=fused_lstm)
    name = cfg.vision.backbone
    if name not in CLIP_CONFIGS:
        raise ValueError(f"the clip text encoder needs a CLIP trunk "
                         f"(cnn_model one of {sorted(CLIP_CONFIGS)}), got "
                         f"{name!r}")
    text, _, _ = tower_configs(CLIP_CONFIGS[name])
    if cfg.vocab_size != text.vocab_size:
        raise ValueError(f"{name}: vocab_size must be {text.vocab_size}, "
                         f"got {cfg.vocab_size}")
    if cfg.text.captioning or cfg.text.attention:
        raise ValueError("the clip text encoder has no LM conditioning")
    return CLIPTextEncoder(text, cfg.embedding_dim,
                           dtype or torch.float32,
                           device=resolve_device(device))


class TextEncoder(nn.Module):
    """``image_feature_map_dim`` is the trunk's channel count (the
    attention's encoder width)."""

    def __init__(self, cfg: ModelConfig, image_feature_map_dim: int = 2048, *,
                 device="cuda", generator: torch.Generator | None = None,
                 fused_lstm: bool | None = None):
        super().__init__()
        t = cfg.text
        arch = t.text_encoder
        if arch not in _ARCHS:
            raise ValueError(f"text_encoder must be one of {_ARCHS}; got "
                             f"{arch!r}")
        if t.pos_embed_type not in _POS_EMBEDS:
            raise ValueError(f"pos_embed_type must be one of {_POS_EMBEDS}; "
                             f"got {t.pos_embed_type!r}")
        if t.captioning and not t.regressional:
            raise ValueError("only the regressional (lstm) text encoder "
                             "supports captioning")
        if t.attention and arch != "lstm":
            raise ValueError("attention requires the lstm text encoder")
        if arch == "cbow" and cfg.embedding_type == "flat":
            raise ValueError("the cbow text encoder needs spatial embeddings")
        device = resolve_device(device)
        self.cfg = cfg
        self.fused_lstm = fused_lstm
        self.vocab_shard = None
        E = cfg.embedding_dim
        H = self.hidden_dim
        # torch nn.Embedding init: N(0, 1), PAD row zeroed
        table = torch.randn(cfg.vocab_size, E, generator=generator)
        table[PAD_TOKEN_ID] = 0.0
        self.embedding = nn.Embedding.from_pretrained(
            table.to(device), freeze=False, padding_idx=PAD_TOKEN_ID)
        if arch in ("lstm", "bilstm"):
            input_dim = E + (image_feature_map_dim if t.attention else 0)
            self.lstm = LSTMCellParams(input_dim, H, arch == "bilstm",
                                       device=device, generator=generator)
        elif arch == "transformer":
            self.transformer_encoder = nn.Module()
            self.transformer_encoder.layers = nn.ModuleList([
                TorchTransformerEncoderLayer(E, nhead=8, device=device,
                                             generator=generator)])
            if t.pos_embed_type == "learned":
                self.pos_embed = nn.Parameter(
                    torch.zeros(MAX_LEN_UTTERANCE, 1, E, device=device))
            elif t.pos_embed_type == "sinusoidal":
                self.register_buffer(
                    "pos_embed",
                    sinusoidal_pos_embed(MAX_LEN_UTTERANCE, E)[:, None]
                    .to(device), persistent=False)
        if t.captioning:  # image features -> (h0, c0)
            self.connector = TorchLinear(E, 2 * self.num_directions * H,
                                         device=device, generator=generator)
        if t.attention:
            self.attention = AdditiveAttention(
                image_feature_map_dim, H, H, t.attention_activation,
                device=device, generator=generator)
            if t.attention_gate:
                self.attention_gate_projection = TorchLinear(
                    H, image_feature_map_dim, device=device,
                    generator=generator)

    @property
    def fused_lstm(self) -> bool | None:
        """The recurrence's kernel rule; validated when set."""
        return self._fused_lstm

    @fused_lstm.setter
    def fused_lstm(self, value: bool | None) -> None:
        check_fused_lstm(value)
        self._fused_lstm = value

    @property
    def hidden_dim(self) -> int:
        # embedding and hidden dims always match
        return self.cfg.embedding_dim

    @property
    def num_directions(self) -> int:
        return 2 if self.cfg.text.text_encoder == "bilstm" else 1

    def init_hidden(self, batch_size: int,
                    image_features: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
        """(h0, c0), each [num_directions, B, H]: zeros, or the connector's
        map of the image features ([B, E], or a spatial map averaged)."""
        d, H = self.num_directions, self.hidden_dim
        if image_features is not None:
            if image_features.dim() > 2:
                image_features = image_features.mean(dim=(1, 2))
            out = self.connector(image_features).reshape(batch_size, 2, d, H)
            return out[:, 0].transpose(0, 1), out[:, 1].transpose(0, 1)
        z = torch.zeros(d, batch_size, H, device=self.embedding.weight.device)
        return z, z

    def ids_to_outputs(self, ids: Tensor, states: Tuple[Tensor, Tensor],
                       image_feature_map: Optional[Tensor] = None,
                       projected_image_feature_map: Optional[Tensor] = None):
        """One decoding step from token ids [B]; states (h, c), each [B, H].
        Returns (outputs [B, H], states, attns)."""
        inputs = self.embed(ids)
        return self.inputs_to_outputs(inputs, states, image_feature_map,
                                      projected_image_feature_map)

    def embed(self, ids: Tensor) -> Tensor:
        """The token embeddings of ``ids`` (PAD's lookups pass no gradient
        to its row), over the model group when the vocab is sharded."""
        if self.vocab_shard is None:
            return padding_safe_embed(self.embedding.weight, ids)
        return vocab_parallel.embed(self.embedding.weight, ids,
                                    self.vocab_shard)

    def inputs_to_outputs(self, inputs: Tensor, states: Tuple[Tensor, Tensor],
                          image_feature_map: Optional[Tensor] = None,
                          projected_image_feature_map: Optional[Tensor] = None
                          ):
        h, c = states
        attns = None
        if image_feature_map is not None:
            attn_feature, attns = self.attention(
                image_feature_map, projected_image_feature_map, h)
            if self.cfg.text.attention_gate:
                attn_feature = torch.sigmoid(
                    self.attention_gate_projection(h)) * attn_feature
            inputs = torch.cat([inputs, attn_feature], dim=-1)
        h_new, c_new = lstm_step(*self.lstm.direction(), inputs, h, c)
        return h_new, (h_new, c_new), attns

    def forward(self, x: Tensor, x_len: Tensor,
                generator: torch.Generator | None = None
                ) -> Tuple[Tensor, Tensor]:
        """x: [B, L] token ids; x_len: [B] lengths. Returns (features
        [B, E] or the spatial outputs, outputs [B, L, E]) of ``encode``
        without image conditioning."""
        ret, output, _ = self.encode(x, x_len, generator)
        return ret, output

    def encode(self, x: Tensor, x_len: Tensor,
               generator: torch.Generator | None = None,
               image_features: Optional[Tensor] = None,
               image_feature_map: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """The JAX encoder's call: (ret, output, attns). ret is the flat
        embedding [B, E] (or the per-step outputs for spatial embeddings),
        output the per-step outputs [B, L, H] that feed the LM head, attns
        the attention weights [B, L, h, w] (attention mode) or None.
        ``image_features`` condition a captioning LSTM's initial state,
        ``image_feature_map`` an attention LSTM's steps."""
        t = self.cfg.text
        arch = t.text_encoder
        flat = self.cfg.embedding_type == "flat"
        B, L = x.shape
        mask = length_mask(x_len, L)
        x_len_f = x_len.float()
        attns = ret = None
        embedding = self.embed(x)

        if arch == "embedding":
            raw = embedding
            if flat:
                ret = raw.sum(dim=1) / x_len_f[:, None]
        elif arch == "cbow":
            c = t.crange
            padded = F.pad(embedding, (0, 0, c + 1, c))
            presum = padded.cumsum(dim=1)
            raw = (presum[:, 2 * c + 1:] - presum[:, :-(2 * c + 1)]
                   - embedding) / (2 * c)
        elif arch in ("lstm", "bilstm"):
            h0, c0 = self.init_hidden(B, image_features)
            emb = locked_dropout(embedding, t.dropout_i, generator)
            if t.attention:
                raw, h_last, attns = self._attention_teacher_forcing(
                    emb, mask, (h0[0], c0[0]), image_feature_map)
                hidden = h_last[None]
            else:
                raw, hf, _ = lstm_scan(*self.lstm.direction(), emb, mask,
                                       h0[0], c0[0], self.fused_lstm)
                hidden = hf[None]
                if arch == "bilstm":
                    out_b_rev, hb, _ = lstm_scan(
                        *self.lstm.direction(reverse=True),
                        reverse_padded(emb, x_len), mask, h0[1], c0[1],
                        self.fused_lstm)
                    out_b = torch.where(mask[:, :, None],
                                        reverse_padded(out_b_rev, x_len), 0.0)
                    raw = (raw + out_b) / 2.0
                    hidden = torch.stack([hf, hb])
            if flat:
                ret = hidden.mean(dim=0)
        else:  # transformer
            emb = embedding
            if hasattr(self, "pos_embed"):
                emb = emb + self.pos_embed[None, :L, 0]
            raw = self.transformer_encoder.layers[0](emb, x == PAD_TOKEN_ID,
                                                     generator)
            if flat:
                ret = raw.sum(dim=1) / x_len_f[:, None]

        output = locked_dropout(raw, t.dropout_o, generator)
        if flat:
            ret = dropout(ret, t.dropout_o, generator)
        else:
            ret = output
        return ret, output, attns

    def _attention_teacher_forcing(self, emb: Tensor, mask: Tensor,
                                   state0: Tuple[Tensor, Tensor],
                                   image_feature_map: Tensor):
        """The attention LSTM over the whole window: each step attends over
        the feature map with the previous h and feeds the attended feature
        beside the token. Returns (outputs [B, L, H], h_last, attns
        [B, L, h, w]), outputs and attns zero at padding."""
        w_ih, w_hh, b_ih, b_hh = self.lstm.direction()
        E = emb.shape[-1]
        H = self.hidden_dim
        w_x, w_a = w_ih[:, :E], w_ih[:, E:]
        x_proj = emb @ w_x.T + b_ih + b_hh
        att = self.attention
        proj_map = att.project_encoder_features(image_feature_map)
        B, L = emb.shape[:2]
        spatial = image_feature_map.shape[1:-1]
        enc_flat = image_feature_map.reshape(B, -1,
                                             image_feature_map.shape[-1])
        proj_flat = proj_map.reshape(B, -1, att.attn_dim)
        h, c = state0
        outs, attns = [], []
        for step in range(L):
            attn_feature, attn = additive_attention(
                enc_flat, proj_flat, h, att.decoder_projection.weight,
                att.decoder_projection.bias, att.attn_layer.weight,
                att.attn_layer.bias, att.activation)
            if self.cfg.text.attention_gate:
                attn_feature = torch.sigmoid(
                    self.attention_gate_projection(h)) * attn_feature
            pre = x_proj[:, step] + attn_feature @ w_a.T + h @ w_hh.T
            i, f, g, o = lstm_gates(pre, H)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            m = mask[:, step, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            outs.append(torch.where(m, h_new, 0.0))
            attns.append(torch.where(m, attn, 0.0))
        return (torch.stack(outs, dim=1), h,
                torch.stack(attns, dim=1).reshape((B, L) + spatial))
