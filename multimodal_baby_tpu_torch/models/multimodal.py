"""CVCL dual encoder and language model (counterpart of
``multimodal_baby_tpu/models/multimodal.py``): the contrastive half with
flat and spatial (mean, max) similarity, and the LM half (the head over
the text encoder's per-step outputs, the joint forward of the train step,
and beam-search decoding).

Parameter names follow the reference's Lightning checkpoint, so
``multimodal_baby_tpu/api/convert.py::convert_cvcl_checkpoint`` maps this
module's ``state_dict()`` to the JAX package's parameter tree:
``vision_encoder.model.{conv1,bn1,layerS.B.*,fc}`` (ResNeXt-50) or
``vision_encoder.model.{patch_embed,cls_token,pos_embed,blocks.*,norm,head}``
(ViT-B/14), ``text_encoder.*`` (``models/text.py``),
``model.logit_neg_log_temperature`` (learned temperature only) and
``language_model.output_layer.{weight,bias}`` (weight only when untied:
tied, the head reads the token embedding).

On a mesh (``parallel/``): ``joint_forward``'s ``gather`` concatenates
the data group's features before the similarity (the global-batch
negatives), and with a vocab-sharded embedding the tied head computes
this rank's vocab slice of the logits and gathers them over the model
group (the padded rows past the vocab dropped) before the bias.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.config import ModelConfig
from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, SOS_TOKEN_ID)
from multimodal_baby_tpu_torch.models.beam_search import beam_search
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.layers import resolve_device
from multimodal_baby_tpu_torch.models.text import TextEncoder
from multimodal_baby_tpu_torch.models.vision import VisionEncoder
from multimodal_baby_tpu_torch.parallel.collectives import (
    model_copy, model_gather)

Tensor = torch.Tensor


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||, 1e-12), torch F.normalize semantics."""
    return x / x.norm(dim=dim, keepdim=True).clamp_min(1e-12)


def spatial_similarity(image_features: Tensor, text_features: Tensor,
                       text_length: Tensor, sim: str) -> Tensor:
    """[I, T] similarity of spatial image features [I, h, w, E] and
    per-token text features [T, L, E] of lengths [T]
    (``multimodal_baby_tpu/models/multimodal.py:35-51``): "mean" averages
    every position-token product over h * w * length, "max" takes each
    token's best position and averages over the length. Padded tokens
    count in both sums, as in the reference."""
    h, w = image_features.shape[1:3]
    length = text_length.to(image_features.dtype)
    if sim == "mean":
        s = torch.einsum("ihwe,tle->it", image_features, text_features)
        return s / (h * w * length[None, :])
    if sim == "max":
        m = torch.einsum("ihwe,tle->itlhw", image_features, text_features)
        return m.amax(dim=(3, 4)).sum(dim=2) / length[None, :]
    raise ValueError(f"unknown sim {sim!r}")


class LMOutputLayer(nn.Module):
    """The LM head's parameters under the reference's names. When tied, the
    kernel is the token embedding and only the bias lives here."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not cfg.tie:
            # flax initializers.uniform(2/sqrt(E)): U[0, 2/sqrt(E))
            w = torch.rand(cfg.vocab_size, cfg.embedding_dim,
                           generator=generator) * (2 / math.sqrt(
                               cfg.embedding_dim))
            self.weight = nn.Parameter(w.to(device))
        if cfg.bias:
            self.bias = nn.Parameter(
                torch.zeros(cfg.vocab_size, device=device))


class CVCL(nn.Module):
    """``dtype`` is the trunk's compute dtype (None = f32); parameters,
    heads, logits and losses stay f32. The model is built on the card
    unless ``device`` says otherwise (``device="cpu"``); asking for the card
    where there is none raises. ``generator`` is a CPU generator for the
    seeded init. ``kernels`` is the kernel configuration
    (``models/kernel_config.py``; None: the JAX package's defaults): the
    trunks' and the LSTM's kernel modes, and the augment's form that the
    train and eval steps read from ``self.kernels``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype | None = None, *,
                 device="cuda", generator: torch.Generator | None = None,
                 kernels: KernelConfig | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.kernels = kernels or KernelConfig()
        self.vision_encoder = VisionEncoder(cfg, dtype, device=device,
                                            generator=generator,
                                            kernels=self.kernels)
        self.text_encoder = TextEncoder(
            cfg, cfg.vision.last_out_dim, device=device, generator=generator,
            fused_lstm=self.kernels.fused_lstm)
        init_val = -math.log(cfg.temperature)
        if cfg.fix_temperature:
            self.register_buffer(
                "fixed_neg_log_temperature",
                torch.tensor(init_val, dtype=torch.float32, device=device),
                persistent=False)
        else:
            self.model = nn.Module()
            self.model.logit_neg_log_temperature = nn.Parameter(
                torch.tensor(init_val, dtype=torch.float32, device=device))
        self.language_model = nn.Module()
        self.language_model.output_layer = LMOutputLayer(
            cfg, device=device, generator=generator)

    @property
    def logit_neg_log_temperature(self) -> torch.Tensor:
        if self.cfg.fix_temperature:
            return self.fixed_neg_log_temperature
        return self.model.logit_neg_log_temperature

    def encode_image(self, image: torch.Tensor, train: bool = False):
        features, feature_map = self.vision_encoder(image, train=train)
        if self.cfg.normalize_features:
            features = l2_normalize(features, dim=-1)
        return features, feature_map

    def encode_text(self, text: torch.Tensor, text_length: torch.Tensor,
                    generator: torch.Generator | None = None):
        """``generator`` draws the text encoder's dropout (None:
        deterministic)."""
        features, outputs = self.text_encoder(text, text_length, generator)
        if self.cfg.normalize_features:
            features = l2_normalize(features, dim=-1)
        return features, outputs

    def similarity(self, image_features: torch.Tensor,
                   text_features: torch.Tensor,
                   text_length: torch.Tensor | None = None) -> torch.Tensor:
        """[I, T]: flat features' products, or ``spatial_similarity`` with
        the config's ``sim`` (spatial embeddings need ``text_length``)."""
        if self.cfg.embedding_type == "flat":
            return image_features @ text_features.T
        return spatial_similarity(image_features, text_features,
                                  text_length, self.cfg.sim)

    def logit_scale(self) -> torch.Tensor:
        return self.logit_neg_log_temperature.exp()

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                text_length: torch.Tensor, train: bool = False,
                return_image_features: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        out = self.joint_forward(image, text, text_length, train=train)
        ret = (out["logits_per_image"], out["logits_per_text"])
        if return_image_features:
            ret = ret + (out["image_features"], out["image_feature_map"])
        return ret

    def joint_forward(self, image: Optional[Tensor], text: Tensor,
                      text_length: Tensor, train: bool = False,
                      generator: torch.Generator | None = None,
                      use_mm: bool = True, use_lm: bool = False,
                      gather: Optional[Callable[[Tensor], Tensor]] = None
                      ) -> Dict[str, Tensor]:
        """Everything the train and eval steps need, with the JAX
        package's reuse rules: the contrastive logits when ``use_mm``; the
        LM's shifted labels and logits when ``use_lm``, reusing the
        contrastive text outputs unless the LM is conditioned on the image
        (captioning or attention), which encodes the text again. In
        training, ``generator`` draws the text encoder's dropout; eval is
        deterministic. ``image`` may be None when neither half reads it.
        ``gather`` (a data-group all-gather) makes the contrastive logits
        those of every rank's features, [B_global, B_global]; the returned
        features stay this rank's."""
        out: Dict[str, Tensor] = {}
        image_features = image_feature_map = text_outputs = None
        t = self.cfg.text
        gen = generator if train else None
        if use_mm:
            image_features, image_feature_map = self.encode_image(
                image, train=train)
            text_features, text_outputs = self.encode_text(
                text, text_length, gen)
            fi, ft, lengths = image_features, text_features, text_length
            if gather is not None:
                fi, ft = gather(fi), gather(ft)
                if self.cfg.embedding_type == "spatial":
                    lengths = gather(lengths)
            match = self.similarity(fi, ft, lengths)
            scale = self.logit_scale()
            out.update(logits_per_image=match * scale,
                       logits_per_text=match.T * scale,
                       image_features=image_features,
                       image_feature_map=image_feature_map,
                       text_outputs=text_outputs)
        if use_lm:
            conditioned = t.captioning or t.attention
            if conditioned and image_features is None:
                image_features, image_feature_map = self.encode_image(
                    image, train=train)
            _, lm_logits, attns = self.lm_forward(
                text, text_length,
                outputs=None if conditioned else text_outputs,
                image_features=image_features if t.captioning else None,
                image_feature_map=image_feature_map if t.attention else None,
                generator=gen)
            out["lm_labels"], out["lm_logits"] = self.lm_labels_and_logits(
                text, lm_logits)
            out["attns"] = attns
            if image_features is not None:
                out["image_features"] = image_features
                out["image_feature_map"] = image_feature_map
        out["logit_neg_log_temperature"] = self.logit_neg_log_temperature
        return out

    # ---------------------------------------------------------------- LM

    def lm_output_layer(self, outputs: Tensor) -> Tensor:
        """[.., H] -> [.., V] logits. Tied, the kernel is the raw token
        embedding, with full gradient (the PAD row's included: only lookups
        stop it)."""
        weight = (self.text_encoder.embedding.weight if self.cfg.tie
                  else self.language_model.output_layer.weight)
        bias = self.language_model.output_layer.bias if self.cfg.bias \
            else None
        shard = self.text_encoder.vocab_shard
        if not self.cfg.tie or shard is None:
            return F.linear(outputs, weight, bias)
        # vocab-sharded tied head: this rank's logits, gathered
        logits = model_gather(F.linear(model_copy(outputs, shard.group),
                                       weight), shard.group)
        logits = logits[..., :self.cfg.vocab_size]
        return logits if bias is None else logits + bias

    def lm_forward(self, y: Tensor, y_len: Tensor,
                   outputs: Optional[Tensor] = None,
                   image_features: Optional[Tensor] = None,
                   image_feature_map: Optional[Tensor] = None,
                   generator: torch.Generator | None = None
                   ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """(outputs [B, L, H], logits [B, L, V], attns); encodes ``y`` unless
        ``outputs`` are given."""
        attns = None
        if outputs is None:
            _, outputs, attns = self.text_encoder.encode(
                y, y_len, generator, image_features, image_feature_map)
        return outputs, self.lm_output_layer(outputs), attns

    def lm_labels_and_logits(self, y: Tensor, logits: Tensor
                             ) -> Tuple[Tensor, Tensor]:
        """Shift by one for the regressional (lstm) encoder."""
        if self.cfg.text.regressional:
            return y[:, 1:], logits[:, :-1]
        return y, logits

    def decode_step(self, ids: Tensor, states: Tuple[Tensor, Tensor],
                    image_feature_map: Optional[Tensor] = None,
                    projected_image_feature_map: Optional[Tensor] = None):
        """One decode step: ids [B] -> (logits [B, V], new states)."""
        outputs, states, _ = self.text_encoder.ids_to_outputs(
            ids, states, image_feature_map, projected_image_feature_map)
        return self.lm_output_layer(outputs), states

    def init_decode_states(self, batch_size: int,
                           image_features: Optional[Tensor] = None):
        h0, c0 = self.text_encoder.init_hidden(batch_size, image_features)
        return h0[0], c0[0]  # single layer, unidirectional

    def project_feature_map(self, image_feature_map: Tensor) -> Tensor:
        return self.text_encoder.attention.project_encoder_features(
            image_feature_map)

    @torch.no_grad()
    def beam_search_decode(self, batch_size: int, beam_width: int = 3,
                           decode_length: int = 25,
                           length_penalty_alpha: float = 0.0,
                           image_features: Optional[Tensor] = None,
                           image_feature_map: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
        """Beam-search text generation from SOS (``models/beam_search.py``)
        with the lstm encoder, optionally conditioned on the image. Returns
        (sequences [B, W, decode_length + 1] with the SOS, scores [B, W]),
        best first."""
        t = self.cfg.text
        if not t.regressional:
            raise ValueError("beam search needs the regressional (lstm) "
                             "text encoder")
        h0, c0 = self.init_decode_states(batch_size, image_features)
        states = (h0, c0)
        if t.attention and image_feature_map is not None:
            # the map and its projection, flattened over space, ride in
            # the states so that the search expands them over the beams
            proj_map = self.project_feature_map(image_feature_map)
            states += (
                image_feature_map.reshape(batch_size, -1,
                                          image_feature_map.shape[-1]),
                proj_map.reshape(batch_size, -1, proj_map.shape[-1]))

        def step(ids, states):
            logits, hc = self.decode_step(ids, states[:2], *states[2:])
            return logits, hc + states[2:]

        start = torch.full((batch_size,), SOS_TOKEN_ID, dtype=torch.long,
                           device=h0.device)
        return beam_search(step, start, beam_width, decode_length,
                           self.cfg.vocab_size, length_penalty_alpha,
                           states=states, eos_id=EOS_TOKEN_ID)
