"""Zero-shot forced-choice evaluation entry point (counterpart of
``multimodal_baby_tpu/cli/eval.py``; reference: eval.py).

    python -m multimodal_baby_tpu_torch.cli.eval --checkpoint <.ckpt> \
        --data_dir data --eval_type image --stage dev [--use_kitty_label] \
        [--device cuda|cpu]

Loads a reference Lightning checkpoint on ``--device`` (the card by
default), runs the forced-choice harness over the eval-trial metadata,
prints the per-class accuracy table and writes the predictions JSON
(schema of eval.py:248-266) to ``--output_dir``.

Not ported: ``--clip_eval`` (the CLIP baseline needs the Hugging Face
CLIP weights) and ``--dump_attention_maps`` (grad-CAM waits for the port
of ``analysis/attention_maps.py``); each refuses with a message.
"""

from __future__ import annotations

import argparse
from pathlib import Path

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
                        help="not ported: grad-CAM overlays wait for the "
                             "port of analysis/attention_maps.py")
    parser.add_argument("--clip_eval", action="store_true",
                        help="not ported: the CLIP baseline needs the "
                             "Hugging Face CLIP weights")
    args = parser.parse_args(argv)

    if args.clip_eval:
        parser.error("--clip_eval is not ported: the CLIP baseline "
                     "(evaluation/clip_baseline.py) needs the Hugging Face "
                     "CLIP weights; run it from the JAX package")
    if args.dump_attention_maps:
        parser.error("--dump_attention_maps is not ported: grad-CAM waits "
                     "for the port of analysis/attention_maps.py")

    from multimodal_baby_tpu_torch.api.model import load_model
    model, _ = load_model(args.checkpoint, device=args.device)

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
    return accs


if __name__ == "__main__":
    main()
