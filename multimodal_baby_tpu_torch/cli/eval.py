"""Zero-shot forced-choice evaluation entry point (counterpart of
``multimodal_baby_tpu/cli/eval.py``; reference: eval.py).

    python -m multimodal_baby_tpu_torch.cli.eval --checkpoint <.ckpt> \
        --data_dir data --eval_type image --stage dev [--use_kitty_label] \
        [--device cuda|cpu]

Loads a reference Lightning checkpoint on ``--device`` (the card by
default), in the kernel configuration of the kernel flags
(``cli/args.py::add_kernel_args``, e.g. ``--vit_int8 1``), runs the
forced-choice harness over the eval-trial metadata, prints the per-class
accuracy table and writes the predictions JSON
(schema of eval.py:248-266) to ``--output_dir``. With
``--dump_attention_maps N`` (image mode), the grad-CAM overlay of each
image of the first N trials goes to
``<output_dir>/attention_maps_<checkpoint>/`` as a PNG (reference:
eval_shuffled.py:196-228); a trial's K images go through the trunk in one
call.

With ``--clip_eval`` it evaluates the CLIP baseline instead of the
checkpoint (reference: eval.py:29-47): ``--clip_model`` names a local
directory or a model in the Hugging Face cache (``api/hf_dir.py``; the
JAX package's default, ``openai/clip-vit-large-patch14``), which the port
reads itself and never downloads; its vision tower runs on K5 and K6 on
the card. It prints the total accuracy, as the JAX package's does.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from multimodal_baby_tpu_torch.cli.args import (
    add_kernel_args, kernel_config_from_args)
from multimodal_baby_tpu_torch.data.datasets import (
    EvalTrialDataset, TextEvalTrialDataset, load_metadata)
from multimodal_baby_tpu_torch.evaluation.forced_choice import (
    print_accuracy_table, run_forced_choice, save_predictions)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--eval_type", type=str, default="image",
                        choices=["image", "text"])
    parser.add_argument("--eval_dataset", type=str, default="saycam",
                        choices=["saycam", "object_categories"])
    parser.add_argument("--stage", type=str, default="dev",
                        choices=["dev", "test"])
    parser.add_argument("--eval_metadata_filename", type=str,
                        default="eval_filtered_dev.json")
    parser.add_argument("--eval_include_sos_eos", action="store_true")
    parser.add_argument("--use_kitty_label", action="store_true")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dump_attention_maps", type=int, default=0,
                        help="save grad-CAM overlays for the first N "
                             "trials (reference: eval_shuffled.py:196-228)")
    parser.add_argument("--clip_eval", action="store_true",
                        help="evaluate the CLIP baseline instead of a CVCL "
                             "checkpoint (reference: eval.py:29-47; the "
                             "weights in a local directory or the Hugging "
                             "Face cache)")
    parser.add_argument("--clip_model", type=str,
                        default="openai/clip-vit-large-patch14")
    add_kernel_args(parser)
    args = parser.parse_args(argv)

    if args.clip_eval:
        return clip_eval(args)

    from multimodal_baby_tpu_torch.api.model import load_model
    model, _ = load_model(args.checkpoint, device=args.device,
                          kernels=kernel_config_from_args(args))

    fname = args.eval_metadata_filename
    if args.stage == "test":
        fname = fname.replace("dev", "test")
    data = load_metadata(Path(args.data_dir) / fname)
    cls = (EvalTrialDataset if args.eval_type == "image"
           else TextEvalTrialDataset)
    dataset = cls(data, model.vocab,
                  eval_include_sos_eos=args.eval_include_sos_eos)

    accs, records = run_forced_choice(
        model.model, dataset, args.eval_type, batch_size=args.batch_size,
        use_kitty_label=args.use_kitty_label, vocab=model.vocab)
    print_accuracy_table(accs)

    ckpt_name = Path(args.checkpoint).stem
    out = Path(args.output_dir) / (
        f"{args.eval_dataset}_{args.eval_type}_{args.stage}_"
        f"{ckpt_name}_predictions.json")
    save_predictions(records, out, {
        "checkpoint": ckpt_name,
        "seed": args.seed,
        "eval_type": args.eval_type,
        "eval_dataset": args.eval_dataset,
        "stage": args.stage,
        "use_kitty_label": args.use_kitty_label,
    })
    print(f"saved predictions to {out}")

    if args.dump_attention_maps > 0 and args.eval_type == "image":
        map_dir = Path(args.output_dir) / f"attention_maps_{ckpt_name}"
        dump_attention_maps(model.model, dataset, args.dump_attention_maps,
                            map_dir)
        print(f"saved attention maps to {map_dir}")
    return accs


def clip_eval(args) -> dict:
    """The CLIP baseline's forced-choice accuracy over the eval trials
    (the JAX package's ``--clip_eval`` branch)."""
    from multimodal_baby_tpu_torch.data.vocab import Vocab
    from multimodal_baby_tpu_torch.evaluation.clip_baseline import (
        CLIPBaseline, run_clip_forced_choice)

    fname = args.eval_metadata_filename
    if args.stage == "test":
        fname = fname.replace("dev", "test")
    data = load_metadata(Path(args.data_dir) / fname)
    # labels come from trial categories; the vocab only keys the dataset
    vocab = Vocab({t["target_category"]: i for i, t in enumerate(data)})
    dataset = EvalTrialDataset(data, vocab)
    baseline = CLIPBaseline(model_name=args.clip_model, device=args.device,
                            kernels=kernel_config_from_args(args))
    acc, _ = run_clip_forced_choice(baseline, dataset,
                                    batch_size=args.batch_size)
    print(f"CLIP baseline total accuracy: {acc:.1%}")
    return {"total": acc}


def dump_attention_maps(model, dataset, n_trials: int, map_dir) -> None:
    """grad-CAM overlays of every image of the first ``n_trials`` image-mode
    trials against the trial's label, one PNG each:
    ``trial{i}_{category}_img{j}.png``."""
    import numpy as np
    import torch
    from PIL import Image

    from multimodal_baby_tpu_torch.analysis.attention_maps import (
        get_attention_overlay, grad_cam)
    from multimodal_baby_tpu_torch.data.augment import normalize_image

    device = next(model.parameters()).device
    Path(map_dir).mkdir(parents=True, exist_ok=True)
    for i in range(min(n_trials, len(dataset))):
        imgs, ids, ln, cat = dataset[i]
        k = imgs.shape[0]
        cams = grad_cam(
            model, normalize_image(torch.from_numpy(imgs).to(device)),
            torch.as_tensor(ids, device=device).long()[None].expand(k, -1),
            torch.full((k,), int(ln), device=device))
        for j in range(k):
            overlay = get_attention_overlay(
                imgs[j].astype(np.float32) / 255.0, cams[j])
            Image.fromarray(
                (np.clip(overlay, 0, 1) * 255).astype(np.uint8)
            ).save(Path(map_dir) / f"trial{i}_{cat}_img{j}.png")


if __name__ == "__main__":
    main()
