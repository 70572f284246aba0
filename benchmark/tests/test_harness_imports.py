"""No module that a run loads has the top-level name of JAX, jaxlib, flax
or the JAX package (``multimodal_baby_tpu``), compared whole: the program,
``multimodal_baby_tpu_torch``, begins with the JAX package's name. The
reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark import harness

REF_FILES = sorted((harness.BENCH / "reference").glob("*.py"))


def _run(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "multimodal_baby_tpu_torch.fake",
                        object())
    assert "multimodal_baby_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "multimodal_baby_tpu.fake", object())
    assert "multimodal_baby_tpu" in harness.forbidden_modules()


def test_a_whole_cpu_run_loads_no_jax():
    code = (
        "import sys, time, torch; from benchmark.tests import tiny; "
        "from benchmark import harness\n"
        "class MP:\n"
        "    def setattr(self, obj, name, value): setattr(obj, name, value)\n"
        "tiny.run_tiny('resnext_train_b512', MP())\n"
        "tiny.run_tiny('resnext_embed_b256', MP(), trace=True)\n"
        "assert 'multimodal_baby_tpu_torch' in {m.split('.')[0] for m in "
        "sys.modules}\n"
        "print('FORBIDDEN', harness.forbidden_modules())")
    out = _run(code)
    assert "FORBIDDEN []" in out


def test_the_reference_loads_no_program_and_no_jax():
    code = ("import sys; import benchmark.reference.cvcl, "
            "benchmark.reference.weights, benchmark.reference.quant; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    tops = _run(code)
    for name in harness.FORBIDDEN + ("multimodal_baby_tpu_torch",):
        assert f"'{name}'" not in tops


def test_reference_sources_import_only_torch_numpy_and_themselves():
    for path in REF_FILES:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top in {"torch", "numpy", "math", "typing", "types",
                               "importlib", "__future__", "benchmark"}, \
                    (path, m)
                assert not m.startswith(("benchmark.loops",
                                         "benchmark.program")), (path, m)
