"""Text-generation evaluation: beam-decode a split and score it with
BLEU, METEOR, ROUGE_L, CIDEr and SPICE (counterpart of
``multimodal_baby_tpu/evaluation/textgen.py``; reference: the
``eval_textgen`` branch of calculate_joint_loss, multimodal_lit.py:325-358,
and pycocoevalcap at the epoch end, :422-440).

Each batch is decoded by ``CVCL.beam_search_decode`` without autograd. A
captioning model first encodes the batch's frames (normalized, the augment
off) through the trunk, on the card its kernel plan, and the decode starts
from the image features; the feature map is not passed, as in the JAX
package (``textgen.py:55-58``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, PAD_TOKEN_ID, SOS_TOKEN_ID)
from multimodal_baby_tpu_torch.data.augment import normalize_image
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.evaluation.textgen_metrics import evaluate
from multimodal_baby_tpu_torch.models.multimodal import CVCL


def ids_to_sentence(ids, vocab: Vocab) -> str:
    """Strip PAD tail, trailing EOS, leading SOS; join words
    (reference: multimodal_lit.py:339-353)."""
    ids = [int(i) for i in ids]
    n = 0
    while n < len(ids) and ids[n] != PAD_TOKEN_ID:
        n += 1
    ids = ids[:n]
    if ids and ids[-1] == EOS_TOKEN_ID:
        ids = ids[:-1]
    if ids and ids[0] == SOS_TOKEN_ID:
        ids = ids[1:]
    return " ".join(vocab.idx2word[i] for i in ids)


@torch.no_grad()
def decode_batch(model: CVCL, batch, beam_width: int = 3,
                 decode_length: int = 25, length_penalty_alpha: float = 0.0,
                 captioning: bool = False) -> torch.Tensor:
    """The best sequence [B, decode_length + 1] (with its SOS) of each
    row of ``batch`` (a dict with ``text``, and ``image_u8`` [B, H, W, 3]
    uint8 when ``captioning``)."""
    b = len(batch["text"])
    image_features = None
    if captioning:
        device = next(model.parameters()).device
        images = torch.as_tensor(batch["image_u8"]).to(device)
        image_features, _ = model.encode_image(normalize_image(images))
    seq, _ = model.beam_search_decode(b, beam_width, decode_length,
                                      length_penalty_alpha, image_features)
    return seq[:, 0]


def run_textgen_eval(
    model: CVCL, batches, vocab: Vocab,
    beam_width: int = 3, decode_length: int = 25,
    length_penalty_alpha: float = 0.0,
    captioning: bool = False,
    print_examples: int = 0,
) -> Tuple[Dict[str, float], List[List[str]], List[str]]:
    """batches: dicts with text/text_len/raw (+ image_u8 when captioning).
    Returns (scores, references, hypotheses)."""
    references: List[List[str]] = []
    hypotheses: List[str] = []
    for batch in batches:
        b = len(batch["text"])
        seq = decode_batch(model, batch, beam_width, decode_length,
                           length_penalty_alpha, captioning).cpu()
        hypotheses += [ids_to_sentence(seq[i], vocab) for i in range(b)]
        raw = batch.get("raw", [""] * b)
        references += [[r] if isinstance(r, str) else list(r)
                       for r in raw]

    for i in range(min(print_examples, len(hypotheses))):
        print(f"example #{i}:")
        print("references:")
        print("\n".join(references[i]))
        print("hypothesis:")
        print(hypotheses[i])

    scores = evaluate(references, hypotheses)
    return scores, references, hypotheses
