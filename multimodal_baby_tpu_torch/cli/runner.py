"""Experiment sweep runner (reference: runner.py): a copy of
``multimodal_baby_tpu/cli/runner.py`` whose jobs launch the port's
trainer, ``multimodal_baby_tpu_torch.cli.train`` (on the card unless
the extra arguments hold ``--device cpu``), and whose job names leave out
a flag the job does not set (``job_name``):

    python -m multimodal_baby_tpu_torch.cli.runner \\
        --config configs.saycam_contrastive [--dry_run] [--auto_flag] \\
        [--emit_scripts DIR] [-- EXTRA TRAIN ARGS]

Consumes the reference's grid-config format — a module with ``grids`` (list
of dicts of lists, expanded cartesian-product) and ``flags`` (ordered keys
for the jobname) — and either runs jobs locally in sequence, prints them
(--dry_run), or writes per-job shell scripts for a scheduler. The reference
sbatch'es SLURM scripts (runner.py:101-174); here a job is one process, so
script emission is scheduler-agnostic.
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import shlex
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

# reference trainer flags with no CLI equivalent here
EXCLUDED_FLAGS = {"main_file", "gpus", "check_val_every_n_epoch",
                  "checkpoint_callback", "logger"}


def expand_grids(grids: List[Dict[str, list]]) -> List[Dict]:
    jobs: List[Dict] = []
    for grid in grids:
        options = [[(k, v) for v in values] for k, values in grid.items()]
        for combo in itertools.product(*options):
            jobs.append(dict(combo))
    return jobs


def varying_keys(grids: List[Dict[str, list]]) -> set:
    merged: Dict[str, set] = {}
    for grid in grids:
        for k, vals in grid.items():
            merged.setdefault(k, set()).update(
                str(v) for v in vals)
    return {k for k, vals in merged.items() if len(vals) > 1}


def job_name(basename: str, job: Dict, flags: List[str]) -> str:
    """``basename`` and each flag's value in the job. A flag the job does
    not set is left out: configs/_base.py's CONTRASTIVE_FLAGS name
    cnn_dino, which the random-CNN and ViT grids drop (the JAX package's
    runner raises KeyError on them unless --auto_flag is given)."""
    name = basename
    for flag in flags:
        if flag in job:
            name += f"_{flag}_{job[flag]}"
    return name


def job_command(job: Dict, exp_name: str, extra_args: List[str]) -> List[str]:
    cmd = [sys.executable, "-m", "multimodal_baby_tpu_torch.cli.train",
           "--exp_name", exp_name]
    for key, value in job.items():
        if key in EXCLUDED_FLAGS:
            continue
        if isinstance(value, bool):
            if value:
                cmd.append(f"--{key}")
        elif isinstance(value, str) and value in ("True", "False"):
            if value == "True":
                cmd.append(f"--{key}")
        else:
            cmd += [f"--{key}", str(value)]
    return cmd + list(extra_args)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="module path of the grid config "
                             "(e.g. configs.saycam_contrastive)")
    parser.add_argument("--basename", type=str, default="exp")
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--auto_flag", action="store_true",
                        help="derive jobname flags from varying keys")
    parser.add_argument("--emit_scripts", type=str, default=None,
                        help="write one shell script per job to this dir "
                             "instead of running")
    parser.add_argument("extra", nargs="*",
                        help="extra args forwarded to every job")
    args = parser.parse_args(argv)

    config_name = args.config
    if config_name.endswith(".py"):
        config_name = config_name[:-3]
    config_name = config_name.replace("/", ".")
    config = importlib.import_module(config_name)
    grids, flags = config.grids, config.flags

    jobs = expand_grids(grids)
    if args.auto_flag:
        flags = sorted(varying_keys(grids))
    else:
        omitted = [k for k in varying_keys(grids) if k not in flags]
        if omitted:
            print(f"ERROR: {', '.join(omitted)} are varying but omitted "
                  f"in flags")
            sys.exit(1)

    print(("NOT starting" if args.dry_run else "Starting")
          + f" {len(jobs)} jobs:")
    for job in jobs:
        name = job_name(args.basename, job, flags)
        cmd = job_command(job, name, args.extra)
        print(" ", " ".join(shlex.quote(c) for c in cmd))
        if args.emit_scripts:
            out = Path(args.emit_scripts)
            out.mkdir(parents=True, exist_ok=True)
            script = out / f"{name}.sh"
            script.write_text("#!/bin/bash\n"
                              + " ".join(shlex.quote(c) for c in cmd)
                              + "\n")
            script.chmod(0o755)
        elif not args.dry_run:
            subprocess.run(cmd, check=True)
    return jobs


if __name__ == "__main__":
    main()
