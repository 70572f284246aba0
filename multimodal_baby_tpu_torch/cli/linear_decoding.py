"""Linear-probe training + forced-choice probe evaluation (counterpart of
``multimodal_baby_tpu/cli/linear_decoding.py``; reference entry points:
linear_decoding.py, eval_linear_decoding.py,
object_categories_linear_decoding.py,
eval_object_categories_linear_decoding.py).

    python -m multimodal_baby_tpu_torch.cli.linear_decoding \
        --checkpoint <.ckpt> --data_dir data \
        --subsets 1.0 0.1 0.01 [--device cuda|cpu]

Trains Linear(backbone_dim -> n_classes) probes on frozen-backbone features
of the dev-stage trial images (Adam lr 5e-4, reference defaults), for each
subset fraction, then scores the test-stage 4-way trials by the
target-class logit (eval_linear_decoding.py:82-101). Saves probe weights
(npz) and a results json. The trunk and the probe run on ``--device``
(the card by default), the trunk in the kernel configuration of the kernel
flags (``cli/args.py::add_kernel_args``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from multimodal_baby_tpu_torch.cli.args import (
    add_kernel_args, kernel_config_from_args)


def _trial_images_and_labels(dataset):
    """Collect (target images, category labels) + full trial image stacks
    from a forced-choice dataset."""
    imgs, cats, trial_stacks = [], [], []
    for i in range(len(dataset)):
        trial_imgs, _, _, cat = dataset[i]
        imgs.append(trial_imgs[0])
        cats.append(cat)
        trial_stacks.append(trial_imgs)
    return np.stack(imgs), cats, np.stack(trial_stacks)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--eval_metadata_filename", type=str,
                        default="eval_filtered_dev.json")
    parser.add_argument("--subsets", type=float, nargs="+",
                        default=[1.0, 0.1, 0.01])
    parser.add_argument(
        "--split", type=str, default=None, choices=["first", "last"],
        help="per-class half split (reference object_categories_linear_"
             "decoding.py:58-77): train on the first/last half of each "
             "class's dev images, report held-out-half accuracy")
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--device", type=str, default="cuda")
    add_kernel_args(parser)
    args = parser.parse_args(argv)

    from multimodal_baby_tpu_torch.api.model import load_model
    from multimodal_baby_tpu_torch.data.datasets import (
        EvalTrialDataset, load_metadata)
    from multimodal_baby_tpu_torch.evaluation.linear_probe import (
        extract_backbone_features, half_split, probe_accuracy,
        probe_forced_choice, train_linear_probe)

    model, _ = load_model(args.checkpoint, device=args.device,
                          kernels=kernel_config_from_args(args))
    data_dir = Path(args.data_dir)
    vocab = model.vocab

    dev = EvalTrialDataset(
        load_metadata(data_dir / args.eval_metadata_filename), vocab)
    test = EvalTrialDataset(
        load_metadata(
            data_dir / args.eval_metadata_filename.replace("dev", "test")),
        vocab)

    train_imgs, train_cats, _ = _trial_images_and_labels(dev)
    _, test_cats, test_stacks = _trial_images_and_labels(test)

    classes = sorted(set(train_cats))
    cls_idx = {c: i for i, c in enumerate(classes)}
    train_labels = np.asarray([cls_idx[c] for c in train_cats])
    test_targets = np.asarray([cls_idx[c] for c in test_cats])

    print(f"extracting features for {len(train_imgs)} train and "
          f"{test_stacks.shape[0]}x{test_stacks.shape[1]} test images")
    feats = extract_backbone_features(model.model, train_imgs)
    n, k = test_stacks.shape[:2]
    test_feats = extract_backbone_features(
        model.model, test_stacks.reshape((-1,) + test_stacks.shape[2:]))
    test_feats = test_feats.reshape(n, k, -1)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    heldout_idx = None
    if args.split:
        probe_train_idx, heldout_idx = half_split(train_labels, args.split)
    else:
        probe_train_idx = np.arange(len(train_labels))

    results = []
    for frac in args.subsets:
        params, metrics = train_linear_probe(
            feats[probe_train_idx], train_labels[probe_train_idx],
            len(classes), lr=args.lr,
            epochs=args.epochs, subset_fraction=frac, seed=args.seed,
            device=args.device)
        acc, preds = probe_forced_choice(params, test_feats, test_targets)
        record = {"subset": frac, "forced_choice_accuracy": acc,
                  **metrics}
        if heldout_idx is not None:
            record["split"] = args.split
            record["heldout_accuracy"] = probe_accuracy(
                params, feats[heldout_idx], train_labels[heldout_idx])
        results.append(record)
        print(f"subset {frac}: train_acc={metrics['train_acc']:.3f} "
              f"forced-choice acc={acc:.3f}")
        np.savez(out_dir / f"probe_subset_{frac}_seed_{args.seed}.npz",
                 preds=preds, classes=np.asarray(classes), **params)

    with open(out_dir / f"linear_decoding_seed_{args.seed}.json", "w") as f:
        json.dump({"results": results, "classes": classes}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
