"""The port's host-only analysis chain against the JAX package's: the
copies of ``summaries``, ``descriptives``, ``word_analysis``,
``token_items``, ``plotting`` and ``figures`` give the same tables and
CSVs (figures: the same files, by name and count, not by pixels) on the
inputs of ``tests/test_analysis.py`` and
``tests/test_word_analysis_plotting.py``; ``CheckpointRegistry`` over a
toy run of the port's trainer on the CPU; and ``cli/analyze.py
summaries|descriptives|figures`` end to end against the JAX package's
CLI, file for file.
"""

import filecmp
import json

import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits

from multimodal_baby_tpu.analysis import descriptives as jdesc
from multimodal_baby_tpu.analysis import figures as jfig
from multimodal_baby_tpu.analysis import plotting as jplot
from multimodal_baby_tpu.analysis import summaries as jsum
from multimodal_baby_tpu.analysis import token_items as jtok
from multimodal_baby_tpu.analysis import word_analysis as jword
from multimodal_baby_tpu.cli import analyze as janalyze
from multimodal_baby_tpu_torch.analysis import descriptives as tdesc
from multimodal_baby_tpu_torch.analysis import figures as tfig
from multimodal_baby_tpu_torch.analysis import plotting as tplot
from multimodal_baby_tpu_torch.analysis import summaries as tsum
from multimodal_baby_tpu_torch.analysis import token_items as ttok
from multimodal_baby_tpu_torch.analysis import word_analysis as tword
from multimodal_baby_tpu_torch.analysis.checkpoints import (
    CheckpointRegistry)
from multimodal_baby_tpu_torch.api.model import CVCLModel
from multimodal_baby_tpu_torch.cli import analyze as tanalyze
from multimodal_baby_tpu_torch.cli import train as ttrain

SPLITS = {
    "train": [{"utterance": "look at the ball",
               "frame_filenames": ["S_20130601_0_0.jpg"] * 3},
              {"utterance": "a cat",
               "frame_filenames": ["S_20140301_1_0.jpg"]}],
    "val": [{"utterance": "the ball",
             "frame_filenames": ["S_20130801_2_0.jpg"]}],
    "test": [{"utterance": "a dog dog",
              "frame_filenames": ["S_20130901_3_0.jpg"]}],
}


def write_pred(path, seed=0, stage="test", eval_dataset="saycam",
               cats=("ball", "dog", "cat", "cup"), correct=True):
    """tests/test_analysis.py::_write_pred's predictions JSON."""
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = [{"checkpoint": f"ckpt_seed_{seed}", "model": "embedding",
             "seed": seed, "shuffle_utterances": False,
             "augment_frames": True, "multiple_frames": True,
             "cnn": "frozen_pretrained", "eval_type": "image",
             "eval_dataset": eval_dataset, "stage": stage, "trial_idx": t,
             "categories": list(cats), "logits": [0.7, 0.1, 0.1, 0.1],
             "pred": 0 if correct else 1, "correct": correct}
            for t in range(3)]
    path.write_text(json.dumps({"data": rows}))


def results_dir(root):
    """Prediction files under every glob the summary writers read (three
    seeds of the embedding runs, one of the others)."""
    s, oc = root / "saycam", root / "object_categories"
    for seed in (0, 1, 2):
        write_pred(s / f"embedding_frozen_pretrained_seed_{seed}_image_"
                   "saycam_test_eval_predictions.json", seed=seed,
                   correct=seed != 1)
        write_pred(s / f"lstm_frozen_pretrained_seed_{seed}_image_saycam_"
                   "test_eval_predictions.json", seed=seed)
    for stem in ("embedding_frozen_pretrained_seed_0_image_saycam_test_"
                 "eval_manual_filtered",
                 "shuffle_embedding_frozen_pretrained_seed_0_image_saycam_"
                 "test_eval",
                 "embedding_linear_probe_seed_0_image_saycam_eval",
                 "clip_image_saycam_test_eval",
                 "transformer_frozen_pretrained_seed_0_image_saycam_test_"
                 "eval"):
        write_pred(s / f"{stem}_predictions.json", cats=("cat", "ball",
                                                         "dog", "cup"))
    for stem in ("embedding_frozen_pretrained_seed_0_image_object_"
                 "categories_test_eval",
                 "embedding_object_categories_linear_probe_seed_1_split_"
                 "last_image_object_categories_eval",
                 "transformer_frozen_pretrained_seed_2_image_object_"
                 "categories_test_eval"):
        write_pred(oc / f"{stem}_predictions.json",
                   eval_dataset="object_categories")
    return root


@pytest.mark.parametrize("writer", [
    "write_bounds_summary", "write_ablations_summary",
    "write_object_categories_summary", "write_transformer_summary"])
def test_summary_csvs_equal_jax(tmp_path, writer):
    """Each of clean.py's summary CSVs, written by both packages from the
    same prediction files, byte for byte (tests/test_analysis.py:143)."""
    d = results_dir(tmp_path / "results")
    got = getattr(tsum, writer)(d, tmp_path / "port.csv")
    want = getattr(jsum, writer)(d, tmp_path / "jax.csv")
    pd.testing.assert_frame_equal(got, want)
    assert len(got) > 0
    assert filecmp.cmp(tmp_path / "port.csv", tmp_path / "jax.csv",
                       shallow=False)


def test_predictions_and_accuracy_tables_equal_jax(tmp_path):
    """load_predictions (a list and a glob), summarize and write_summary
    (tests/test_analysis.py:22, 392)."""
    d = results_dir(tmp_path / "results")
    pattern = str(d / "saycam" / "*_predictions.json")
    for src in (pattern, [d / "saycam" / "clip_image_saycam_test_eval_"
                          "predictions.json"]):
        got, want = tsum.load_predictions(src), jsum.load_predictions(src)
        pd.testing.assert_frame_equal(got, want)
        pd.testing.assert_frame_equal(tsum.summarize(got),
                                      jsum.summarize(want))
    tsum.write_summary(pattern, tmp_path / "port.csv")
    jsum.write_summary(pattern, tmp_path / "jax.csv")
    assert filecmp.cmp(tmp_path / "port.csv", tmp_path / "jax.csv",
                       shallow=False)


def test_descriptives_equal_jax(tmp_path):
    """The corpus statistics and the descriptives tables
    (tests/test_analysis.py:88, 283) on the same splits."""
    for split, rows in SPLITS.items():
        (tmp_path / f"{split}.json").write_text(json.dumps({"data": rows}))
    utts = ["look at the ball", "a cat", "the ball", "", "a dog dog"]
    assert tdesc.corpus_stats(utts) == jdesc.corpus_stats(utts)
    assert tdesc.length_distribution(utts) == \
        jdesc.length_distribution(utts)
    pd.testing.assert_frame_equal(tdesc.frequency_table(utts),
                                  jdesc.frequency_table(utts))
    df = tdesc.load_split_frame(tmp_path)
    pd.testing.assert_frame_equal(df, jdesc.load_split_frame(tmp_path))
    for vocab_size in (None, 10):
        pd.testing.assert_frame_equal(
            tdesc.dataset_descriptives(df, vocab_size),
            jdesc.dataset_descriptives(df, vocab_size))
    assert tdesc.date_descriptives(df) == jdesc.date_descriptives(df)
    pd.testing.assert_frame_equal(
        tdesc.category_word_freq_subsets(utts, ["ball", "cat"]),
        jdesc.category_word_freq_subsets(utts, ["ball", "cat"]))
    for cat, n in (("ball", 2), ("cat", 1)):
        (tmp_path / "labeled_s" / cat).mkdir(parents=True)
        for i in range(n):
            (tmp_path / "labeled_s" / cat / f"{i}.jpeg").write_bytes(b"")
    for train in (None, utts):
        pd.testing.assert_frame_equal(
            tdesc.labeled_s_descriptives(tmp_path / "labeled_s", train),
            jdesc.labeled_s_descriptives(tmp_path / "labeled_s", train))


def test_word_analysis_equal_jax(tmp_path):
    """POS tags (the lexicon tagger, its cache), the curated categories,
    the per-category summary and the ratings join
    (tests/test_word_analysis_plotting.py)."""
    words = ["the", "kitty", "running", "quickly", "on", "7", "is", "red",
             "ball", "in", "and", "oh", "let's", "zzz"]
    tags = tword.pos_tag(words, cache_path=tmp_path / "port.json")
    assert tags == jword.pos_tag(words, cache_path=tmp_path / "jax.json")
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
    assert tword.pos_tag(["the", "dog"], tmp_path / "port.json") == \
        jword.pos_tag(["the", "dog"], tmp_path / "jax.json")
    assert {t: tword.syntactic_category(t) for t in
            tword.SYNTACTIC_CATEGORY} == {
        t: jword.syntactic_category(t) for t in jword.SYNTACTIC_CATEGORY}
    assert tword.load_word_categories() == jword.load_word_categories()
    assert tword.UNTYPICAL_WORDS == jword.UNTYPICAL_WORDS
    summary = pd.DataFrame({
        "token": ["ball", "the", "zzz", "kitty", "let's", "tractor"],
        "mean_ce": [1.0, 2.0, 3.0, 1.5, 99.0, 3.0],
        "count": [10, 30, 5, 2, 100, 1]})
    for exclude in (True, False):
        pd.testing.assert_frame_equal(
            tword.per_category_summary(summary, exclude_untypical=exclude),
            jword.per_category_summary(summary, exclude_untypical=exclude))
    ratings = tmp_path / "ratings.csv"
    ratings.write_text("word,aoa,concreteness\nkitty,20.1,4.9\n"
                       "ball,15.3,5.0\n")
    pd.testing.assert_frame_equal(tword.join_ratings(summary, ratings),
                                  jword.join_ratings(summary, ratings))


def token_runs(seed=0):
    rng = np.random.RandomState(seed)

    def run(losses):
        tokens, ls, hid = [], [], []
        for w, word_losses in losses.items():
            for value in word_losses:
                tokens.append(w)
                ls.append(value)
                hid.append(rng.randn(8))
        return {"token": np.asarray(tokens),
                "ce_loss": np.asarray(ls, np.float64),
                "position": np.zeros(len(ls)), "hidden": np.asarray(hid)}

    return {"lstm": run({"ball": [1.0, 3.0], "the": [0.5], "kitty": [2.0],
                         "running": [4.0], "cat": [1.0, 1.0]}),
            "ngram": run({"ball": [2.0, 2.0], "the": [1.5], "kitty": [1.0],
                          "running": [4.0], "car": [0.5]})}


def test_token_items_equal_jax(tmp_path):
    """build_token_items with PCA and t-SNE coordinates, a baseline, a
    count floor and a ratings join (tests/test_analysis.py:323), on one
    OpenMP thread (t-SNE beside other test workers)."""
    ratings = tmp_path / "ratings.csv"
    ratings.write_text("word,aoa\nkitty,20.1\nball,15.3\n")
    with threadpool_limits(1):
        for kw in (dict(embed_methods=("pca", "tsne")),
                   dict(baseline_name="lstm", min_count=2,
                        embed_methods=(), ratings_csv=ratings)):
            got = ttok.build_token_items(token_runs(), **kw)
            want = jtok.build_token_items(token_runs(), **kw)
            pd.testing.assert_frame_equal(got, want)
    assert list(got["token"]) == ["ball", "cat"]
    assert {"ngram loss - lstm loss", "aoa"} <= set(got.columns)


def test_plots_and_figures_write_the_jax_files(tmp_path):
    """plotting's figures and figures.render_all write the same files (by
    name and count) as the JAX package's; frame_subplots and untokenize
    equal (tests/test_analysis.py:419)."""
    import matplotlib.pyplot as plt
    rng = np.random.RandomState(0)
    coords, feats, sim = rng.randn(30, 2), rng.randn(8, 16), rng.rand(5, 5)
    labels = ["a"] * 10 + ["b"] * 10 + ["c"] * 10
    for pkg, mod in (("port", tplot), ("jax", jplot)):
        d = tmp_path / pkg
        mod.scatter_embeddings(coords, labels, highlight=["b"],
                               save_path=d / "scatter.png")
        mod.similarity_heatmap(sim, list("abcde"), save_path=d / "heat.png")
        mod.dendrogram(feats, [f"w{i}" for i in range(8)],
                       save_path=d / "dendro.png")
        plt.close("all")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        ["dendro.png", "heat.png", "scatter.png"]
    for s in ("do n't do that !", "that 's the ball .", "gon na go"):
        assert tplot.untokenize(s) == jplot.untokenize(s)
    fig, ax, w = tplot.frame_subplots(2, 3)
    jfig_, jax_ax, jw = jplot.frame_subplots(2, 3)
    assert ax.shape == jax_ax.shape and w == jw
    assert tuple(fig.get_size_inches()) == tuple(jfig_.get_size_inches())
    plt.close("all")

    rows = []
    for config in ("contrastive", "shuffled"):
        for seed in (0, 1):
            for cat in ("ball", "cat", "car"):
                for t in range(20):
                    rows.append({"config": config, "seed": seed,
                                 "target_category": cat,
                                 "correct": int(rng.rand() < 0.5),
                                 "filtered": t % 2 == 0})
    csv = tmp_path / "summary.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    utts = ["the red ball", "a cat", "look a car"]
    got = tfig.render_all(csv, tmp_path / "port_figs", utterances=utts)
    want = jfig.render_all(csv, tmp_path / "jax_figs", utterances=utts)
    assert [p.name for p in got] == [p.name for p in want] == [
        "eval_accuracy.png", "config_comparison.png",
        "seed_consistency.png", "corpus_descriptives.png"]
    assert all(p.stat().st_size > 1000 for p in got)
    assert tfig._bootstrap_ci(np.arange(10.0)) == \
        jfig._bootstrap_ci(np.arange(10.0))


def test_checkpoint_registry_on_a_trainer_run(tmp_path):
    """scan and load over two toy runs of the port's trainer on the CPU:
    each entry's fields from its config.json and index.json, and load's
    model equal to from_checkpoint_dir's, feature for feature."""
    for seed, encoder in ((0, "embedding"), (1, "lstm")):
        ttrain.main(["--dataset", "synthetic", "--cnn_model", "toy",
                     "--fast_dev_run", "--device", "cpu", "--batch_size",
                     "8", "--embedding_dim", "16", "--num_workers", "2",
                     "--compute_dtype", "float32", "--text_encoder",
                     encoder, "--seed", str(seed), "--checkpoint_dir",
                     str(tmp_path), "--exp_name", f"run{seed}"])
    reg = CheckpointRegistry(tmp_path)
    reg.register("elsewhere", tmp_path / "x", note="external")
    found = reg.scan()
    assert list(reg) == ["run0", "run1", "elsewhere"]
    assert found["elsewhere"] == {"path": str(tmp_path / "x"),
                                  "note": "external"}
    for seed, encoder in ((0, "embedding"), (1, "lstm")):
        entry = found[f"run{seed}"]
        index = json.loads((tmp_path / f"run{seed}" / "index.json")
                           .read_text())
        assert entry == {"path": str(tmp_path / f"run{seed}"),
                         "text_encoder": encoder, "embedding_dim": 16,
                         "seed": seed,
                         "best_val_loss": index["best"][0]["val_loss"],
                         "last_epoch": 0}
        model = reg.load(f"run{seed}", device="cpu")
        want = CVCLModel.from_checkpoint_dir(entry["path"], device="cpu")
        images = np.random.RandomState(seed).randint(
            0, 256, (2, 64, 64, 3)).astype(np.float32) / 255
        torch.testing.assert_close(model.encode_image(images),
                                   want.encode_image(images), rtol=0,
                                   atol=0)
        for a, b in zip(model.model.state_dict().values(),
                        want.model.state_dict().values()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("cmd", ["summaries", "descriptives", "figures"])
def test_cli_analyze_end_to_end_equal_jax(tmp_path, cmd, capsys):
    """Each subcommand of both packages' CLIs on the same inputs: the same
    files, the CSVs byte for byte, the figures by name; the same lines on
    stdout."""
    outs = {}
    for pkg, mod in (("port", tanalyze), ("jax", janalyze)):
        d = tmp_path / pkg
        if cmd == "summaries":
            argv = ["--results_dir", str(results_dir(d))]
        elif cmd == "descriptives":
            d.mkdir()
            for split, rows in SPLITS.items():
                (d / f"{split}.json").write_text(json.dumps({"data": rows}))
            (d / "vocab.json").write_text(json.dumps({"a": 0, "b": 1}))
            argv = ["--data_dir", str(d), "--out_csv", str(d / "out.csv")]
        else:
            d.mkdir()
            csv = d / "summary.csv"
            write_pred(d / "preds.json")
            tsum.write_summary_csv(
                [{"paths": [d / "preds.json"], "config": "contrastive"}],
                csv)
            (d / "train.json").write_text(json.dumps(
                {"data": SPLITS["train"]}))
            argv = ["--summary_csv", str(csv), "--out_dir", str(d / "figs"),
                    "--metadata", str(d / "train.json")]
        mod.main([cmd, *argv])
        outs[pkg] = capsys.readouterr().out.replace(str(d), "<dir>")
    assert outs["port"] == outs["jax"]
    port, jax = tmp_path / "port", tmp_path / "jax"
    files = sorted(p.relative_to(port) for p in port.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(jax) for p in jax.rglob("*")
                           if p.is_file())
    for rel in files:
        if rel.suffix in (".csv", ".json"):
            assert filecmp.cmp(port / rel, jax / rel, shallow=False), rel
    assert any(rel.suffix == {"figures": ".png"}.get(cmd, ".csv")
               for rel in files)
