"""The port's train CLI: its flags and config against the JAX package's,
a CPU smoke run of every optimizer, the refusals, and evaluating what it
wrote with the eval CLI."""

import argparse
import importlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_baby_tpu.cli import args as jargs
from multimodal_baby_tpu.cli.runner import EXCLUDED_FLAGS, expand_grids
from multimodal_baby_tpu_torch.cli import args as targs
from multimodal_baby_tpu_torch.cli import eval as teval
from multimodal_baby_tpu_torch.cli import train as ttrain

REPO = Path(__file__).resolve().parents[1]
RECIPES = sorted(p.stem for p in (REPO / "configs").glob("saycam_*.py"))
# the flags that put the published recipe's train step on the kernels, and
# the CPU tests' precision
EXTRAS = ([], ["--trunk_int8", "0,0,1,1", "--frozen_bn", "running"],
          ["--compute_dtype", "float32"])
PORT_ONLY = {"device", "synthetic_size"}


def parse(module, argv):
    parser = argparse.ArgumentParser()
    module.add_all_args(parser)
    return module.args_to_config(parser.parse_args(argv))


def recipe_argv(name):
    """The argv of every job of the recipe's grid: a boolean is a bare
    flag where the flag stores True, else a value (``--tie True``)."""
    parser = argparse.ArgumentParser()
    jargs.add_all_args(parser)
    bare = {a.dest for a in parser._actions
            if isinstance(a, argparse._StoreTrueAction)}
    grids = importlib.import_module(f"configs.{name}").grids
    jobs = []
    for job in expand_grids(grids):
        argv = []
        for key, value in job.items():
            if key in EXCLUDED_FLAGS:
                continue
            if key in bare:
                argv += [f"--{key}"] if value in (True, "True") else []
            else:
                argv += [f"--{key}", str(value)]
        jobs.append(argv)
    return jobs


@pytest.mark.parametrize("recipe", RECIPES)
def test_args_to_config_matches_jax(recipe):
    """Every job of the recipe's grid, with each of EXTRAS: the same
    ExperimentConfig JSON from both packages' parsers."""
    jobs = recipe_argv(recipe)
    assert jobs
    for argv in jobs:
        for extra in EXTRAS:
            want = parse(jargs, argv + extra).to_json()
            assert parse(targs, argv + extra).to_json() == want


def test_flags_are_the_jax_packages():
    """The same flags and defaults, plus the port's --device and
    --synthetic_size."""
    def flags(module):
        parser = argparse.ArgumentParser()
        module.add_all_args(parser)
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    got, want = flags(targs), flags(jargs)
    assert set(got) - set(want) == PORT_ONLY
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"


def smoke_argv(tmp_path, *extra):
    return ["--dataset", "synthetic", "--cnn_model", "toy",
            "--fast_dev_run", "--device", "cpu", "--batch_size", "8",
            "--embedding_dim", "16", "--num_workers", "2",
            "--compute_dtype", "float32",
            "--checkpoint_dir", str(tmp_path), *extra]


@pytest.mark.parametrize("optimizer", ["AdamW", "Adam", "SGD"])
def test_fast_dev_run_on_cpu(tmp_path, optimizer):
    """One small epoch on the toy trunk: a finite val loss, a checkpoint
    directory, and the trainer on the CPU as asked."""
    out = ttrain.main(smoke_argv(tmp_path, "--optimizer", optimizer,
                                 "--exp_name", optimizer))
    assert math.isfinite(out["loss"])
    ckdir = tmp_path / optimizer
    assert (ckdir / "last" / "state.pt").exists()
    cfg = json.loads((ckdir / "config.json").read_text())
    assert cfg["train"]["optimizer"] == optimizer
    assert cfg["data"]["synthetic_size"] == 16


def test_prepare_data_only(tmp_path, capsys):
    assert ttrain.main(["--prepare_data_only", "--data_dir",
                        str(tmp_path)]) is None
    assert "prepare_data complete" in capsys.readouterr().out


def test_refusals(tmp_path):
    """A mesh the world does not cover (--mesh 2,1 without torchrun: one
    device, the JAX package's message) and the card where there is none:
    each raises before any data is made or any file written. Text
    generation in validation no longer refuses: the joint recipe's
    ``--eval_textgen`` validates with the scores."""
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        ttrain.main(smoke_argv(tmp_path, "--mesh", "2,1"))
    if not torch.cuda.is_available():
        argv = smoke_argv(tmp_path)
        argv[argv.index("cpu")] = "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(argv)
    assert not any(tmp_path.iterdir())
    # one device, however the mesh names it, trains
    assert ttrain.make_trainer(smoke_argv(
        tmp_path, "--mesh", "1,-1", "--per_shard_negatives")) is not None
    out = ttrain.main(smoke_argv(
        tmp_path, "--exp_name", "textgen", "--text_encoder", "lstm",
        "--lambda_mm", "0.5", "--lambda_lm", "0.5", "--optimize_unused",
        "--eval_textgen", "--beam_width", "2", "--decode_length", "4"))
    for k in ("Bleu_1", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"):
        assert math.isfinite(out[k]), k


def test_eval_cli_reads_a_trained_directory(tmp_path):
    """cli/eval.py --checkpoint <the train CLI's directory> runs the
    forced-choice trials with the trained model and its vocab."""
    from PIL import Image
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    frames = []
    for i in range(5):
        frames.append(str(data / f"f{i}.png"))
        Image.fromarray(rng.randint(0, 256, (224, 224, 3),
                                    np.uint8)).save(frames[-1])
    trials = [{"target_category": f"w{5 + i}",
               "target_img_filename": frames[i],
               "foil_categories": ["w1", "w2", "w3"],
               "foil_img_filenames": frames[i + 1:i + 4]}
              for i in range(2)]
    (data / "eval_filtered_dev.json").write_text(
        json.dumps({"data": trials}))
    ttrain.main(smoke_argv(tmp_path / "ck"))
    accs = teval.main(["--checkpoint", str(tmp_path / "ck" / "default"),
                       "--data_dir", str(data), "--device", "cpu",
                       "--output_dir", str(tmp_path / "out")])
    assert 0.0 <= accs["total"] <= 1.0
    assert len(list((tmp_path / "out").iterdir())) == 1
