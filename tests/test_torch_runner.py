"""The port's sweep runner (``cli/runner.py``) against the JAX package's on
every grid in ``configs/``: the same job list under ``--dry_run`` (with
and without ``--auto_flag``, with extra arguments), the same scripts under
``--emit_scripts``, with only the train module's name changed; and every
job's argv parses under the port's train CLI with no unknown flag.
"""

import importlib
import shlex
from pathlib import Path

import pytest

from multimodal_baby_tpu.cli import runner as jrunner
from multimodal_baby_tpu_torch.cli import runner as trunner
from multimodal_baby_tpu_torch.cli.train import build_parser

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.stem for p in (REPO / "configs").glob("*.py")
                 if not p.stem.startswith("_"))
JAX_TRAIN = "multimodal_baby_tpu.cli.train"
PORT_TRAIN = "multimodal_baby_tpu_torch.cli.train"
EXTRA = ["--device", "cpu", "--max_epochs", "1"]


@pytest.mark.parametrize("config", CONFIGS)
def test_runner_matches_jax(config, tmp_path, capsys, monkeypatch):
    """--dry_run's printed jobs and returned job dicts, in both flag
    modes, and --emit_scripts' files: the JAX package's with the train
    module renamed. Every job parses under the port's train CLI."""
    module = f"configs.{config}"
    cfg = importlib.import_module(module)
    # the JAX runner names jobs by every flag and raises on a grid that
    # drops one (cnn_dino in the random-CNN and ViT grids); the port's
    # leaves it out, so the JAX side runs with the flags the jobs set
    jobs = jrunner.expand_grids(cfg.grids)
    partial = [f for f in cfg.flags if not all(f in job for job in jobs)]
    assert partial in ([], ["cnn_dino"])
    for flags in ([], ["--auto_flag"]):
        argv = ["--config", module, "--dry_run", *flags, "--", *EXTRA]
        assert trunner.main(argv) == jobs
        got = capsys.readouterr().out
        if partial and not flags:
            with pytest.raises(KeyError, match="cnn_dino"):
                jrunner.main(argv)
            capsys.readouterr()
            monkeypatch.setattr(cfg, "flags", [f for f in cfg.flags
                                               if f not in partial])
        assert jrunner.main(argv) == jobs
        monkeypatch.undo()
        assert got == capsys.readouterr().out.replace(JAX_TRAIN,
                                                      PORT_TRAIN)
        assert got.startswith(f"NOT starting {len(jobs)} jobs:")
    lines = got.splitlines()[1:]
    assert len(lines) == len(jobs)
    parser = build_parser()
    for line in lines:
        cmd = shlex.split(line)
        assert cmd[1:3] == ["-m", PORT_TRAIN]
        args = parser.parse_args(cmd[3:])  # exits on an unknown flag
        assert args.device == "cpu" and args.max_epochs == 1

    for pkg, mod in (("port", trunner), ("jax", jrunner)):
        mod.main(["--config", module, "--emit_scripts", str(tmp_path / pkg),
                  "--basename", "sweep", "--auto_flag", "--", *EXTRA])
    capsys.readouterr()
    port, jax = tmp_path / "port", tmp_path / "jax"
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax.iterdir())
    assert len(names) == len(jobs)
    for name in names:
        text = (port / name).read_text()
        assert text == (jax / name).read_text().replace(JAX_TRAIN,
                                                        PORT_TRAIN)
        assert text.startswith("#!/bin/bash\n") and PORT_TRAIN in text
        assert (port / name).stat().st_mode & 0o111


def test_runner_refuses_an_unnamed_varying_key(tmp_path, monkeypatch,
                                               capsys):
    """A grid key that varies but is not in ``flags`` stops the runner, as
    in the JAX package."""
    (tmp_path / "grid_cfg.py").write_text(
        "grids = [{'lr': [1e-4, 1e-3], 'seed': [0]}]\nflags = ['seed']\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(SystemExit) as e:
        trunner.main(["--config", "grid_cfg", "--dry_run"])
    assert e.value.code == 1
    assert "lr are varying but omitted" in capsys.readouterr().out
