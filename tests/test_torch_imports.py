"""The port imports neither JAX nor the JAX package, nor the Hugging Face
libraries that the JAX package's CLIP baseline uses (``transformers``,
``tokenizers``, ``safetensors``, ``huggingface_hub``).

Checked in a fresh interpreter: this test process has JAX loaded already
(tests/conftest.py).
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "multimodal_baby_tpu_torch",
    "multimodal_baby_tpu_torch.core",
    "multimodal_baby_tpu_torch.ops.bottleneck",
    "multimodal_baby_tpu_torch.ops.quant",
    "multimodal_baby_tpu_torch.ops.stage",
    "multimodal_baby_tpu_torch.ops.vit_common",
    "multimodal_baby_tpu_torch.ops.attention",
    "multimodal_baby_tpu_torch.ops.vit_mlp",
    "multimodal_baby_tpu_torch.ops.vit_block",
    "multimodal_baby_tpu_torch.ops.lstm",
    "multimodal_baby_tpu_torch.ops.infonce",
    "multimodal_baby_tpu_torch.ops.conv_epilogue",
    "multimodal_baby_tpu_torch.models.layers",
    "multimodal_baby_tpu_torch.models.attention",
    "multimodal_baby_tpu_torch.models.beam_search",
    "multimodal_baby_tpu_torch.models.vision_resnext",
    "multimodal_baby_tpu_torch.models.quant_calib",
    "multimodal_baby_tpu_torch.models.vision_vit",
    "multimodal_baby_tpu_torch.models.vision",
    "multimodal_baby_tpu_torch.models.text",
    "multimodal_baby_tpu_torch.models.multimodal",
    "multimodal_baby_tpu_torch.models.losses",
    "multimodal_baby_tpu_torch.data.augment",
    "multimodal_baby_tpu_torch.train.optimizer",
    "multimodal_baby_tpu_torch.train.step",
    "multimodal_baby_tpu_torch.train.metrics",
    "multimodal_baby_tpu_torch.train.checkpoint",
    "multimodal_baby_tpu_torch.train.profiler",
    "multimodal_baby_tpu_torch.train.trainer",
    "multimodal_baby_tpu_torch.data.loader",
    "multimodal_baby_tpu_torch.data.modules",
    "multimodal_baby_tpu_torch.cli.args",
    "multimodal_baby_tpu_torch.cli.train",
    "multimodal_baby_tpu_torch.api.convert",
    "multimodal_baby_tpu_torch.api.model",
    "multimodal_baby_tpu_torch.data.vocab",
    "multimodal_baby_tpu_torch.data.tokenizer",
    "multimodal_baby_tpu_torch.data.datasets",
    "multimodal_baby_tpu_torch.data.object_categories",
    "multimodal_baby_tpu_torch.evaluation",
    "multimodal_baby_tpu_torch.evaluation.forced_choice",
    "multimodal_baby_tpu_torch.evaluation.linear_probe",
    "multimodal_baby_tpu_torch.cli",
    "multimodal_baby_tpu_torch.cli.eval",
    "multimodal_baby_tpu_torch.cli.parity",
    "multimodal_baby_tpu_torch.cli.linear_decoding",
    "multimodal_baby_tpu_torch.cli.analyze",
    "multimodal_baby_tpu_torch.evaluation.porter",
    "multimodal_baby_tpu_torch.evaluation.textgen_metrics",
    "multimodal_baby_tpu_torch.evaluation.meteor",
    "multimodal_baby_tpu_torch.evaluation.spice",
    "multimodal_baby_tpu_torch.evaluation.textgen",
    "multimodal_baby_tpu_torch.analysis",
    "multimodal_baby_tpu_torch.analysis.attention_maps",
    "multimodal_baby_tpu_torch.analysis.representation_similarity",
    "multimodal_baby_tpu_torch.analysis.embeddings",
    "multimodal_baby_tpu_torch.analysis.duplicates",
    "multimodal_baby_tpu_torch.analysis.ngram",
    "multimodal_baby_tpu_torch.analysis.processing",
    "multimodal_baby_tpu_torch.data.native",
    "multimodal_baby_tpu_torch.analysis.descriptives",
    "multimodal_baby_tpu_torch.analysis.summaries",
    "multimodal_baby_tpu_torch.analysis.word_analysis",
    "multimodal_baby_tpu_torch.analysis.token_items",
    "multimodal_baby_tpu_torch.analysis.plotting",
    "multimodal_baby_tpu_torch.analysis.figures",
    "multimodal_baby_tpu_torch.analysis.checkpoints",
    "multimodal_baby_tpu_torch.cli.runner",
    "multimodal_baby_tpu_torch.data.etl",
    "multimodal_baby_tpu_torch.data.coco",
    "multimodal_baby_tpu_torch.api.backbones",
    "multimodal_baby_tpu_torch.parallel",
    "multimodal_baby_tpu_torch.parallel.mesh",
    "multimodal_baby_tpu_torch.parallel.collectives",
    "multimodal_baby_tpu_torch.parallel.vocab",
    "multimodal_baby_tpu_torch.models.kernel_config",
    "multimodal_baby_tpu_torch.api.hf_dir",
    "multimodal_baby_tpu_torch.data.clip_tokenizer",
    "multimodal_baby_tpu_torch.models.clip",
    "multimodal_baby_tpu_torch.evaluation.clip_baseline",
]

PROBE = """
import importlib, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax"))
             or m == "multimodal_baby_tpu"
             or m.startswith("multimodal_baby_tpu.")
             or m.split(".")[0] in ("transformers", "tokenizers",
                                    "safetensors", "huggingface_hub"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(modules=MODULES)], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's module scope and its imports of the port."""
    probe = PROBE.replace("importlib.import_module(name)",
                          "importlib.import_module(name)\n"
                          "import runpy; runpy.run_path('chip_smoke.py')")
    proc = subprocess.run(
        [sys.executable, "-c", probe.format(modules=MODULES)], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_real_io_script_imports_no_jax():
    """scripts/real_io_torch.py's module scope and its imports."""
    probe = PROBE.replace("importlib.import_module(name)",
                          "importlib.import_module(name)\n"
                          "import runpy; runpy.run_path("
                          "'scripts/real_io_torch.py')")
    proc = subprocess.run(
        [sys.executable, "-c", probe.format(modules=MODULES)], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_phase14_script_imports_no_jax():
    """scripts/chip_phase14.py's module scope and its imports."""
    probe = PROBE.replace("importlib.import_module(name)",
                          "importlib.import_module(name)\n"
                          "import runpy; runpy.run_path("
                          "'scripts/chip_phase14.py')")
    proc = subprocess.run(
        [sys.executable, "-c", probe.format(modules=MODULES)], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_phase15_script_imports_no_jax():
    """scripts/chip_phase15.py's module scope and its imports."""
    probe = PROBE.replace("importlib.import_module(name)",
                          "importlib.import_module(name)\n"
                          "import runpy; runpy.run_path("
                          "'scripts/chip_phase15.py')")
    proc = subprocess.run(
        [sys.executable, "-c", probe.format(modules=MODULES)], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              check=False)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_parallel_worker_imports_no_jax():
    """tests/torch_parallel_worker.py, which the gloo ranks of
    tests/test_torch_parallel.py import to find their target."""
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(
            modules=["tests.torch_parallel_worker"])], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
