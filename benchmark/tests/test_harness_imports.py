"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port either. A module's top-level name
is compared whole: ``supereight_tpu_torch`` starts with
``supereight_tpu``."""

import subprocess
import sys

from benchmark import run

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""


def _run(blocked, body):
    code = f"BLOCKED = {tuple(blocked)!r}\n" + BLOCKER + body
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_imports_without_jax():
    body = """
import importlib, pathlib
import benchmark.run, benchmark.control, benchmark.loop, benchmark.trace
import benchmark.reference.step, benchmark.reference.compare
import supereight_tpu_torch.pipeline
for p in sorted(pathlib.Path("benchmark/metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location(p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
held = {m.split(".")[0] for m in sys.modules}
print(sorted(held & set(BLOCKED)))
"""
    assert _run(run.FORBIDDEN, body).strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    body = """
import benchmark.reference.step, benchmark.reference.compare
import benchmark.loop
print(sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED)))
"""
    assert _run(run.FORBIDDEN + ("supereight_tpu_torch",),
                body).strip() == "[]"


def test_forbidden_names_compare_whole():
    assert "supereight_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "supereight_tpu.pipeline".split(".")[0] in run.FORBIDDEN
