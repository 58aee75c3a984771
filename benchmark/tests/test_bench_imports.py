"""Nothing the benchmark runs on the chip holds JAX or the JAX package
(top-level module names compared whole: the port's own name begins with
the JAX package's), and the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from benchmark.harness.main import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _py_files(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_compared_whole():
    assert forbidden_modules(["otvm_tpu_torch", "otvm_tpu_torch.models", "jaxtyping"]) == []
    assert forbidden_modules(["otvm_tpu.models", "jax", "jaxlib.xla", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla", "otvm_tpu.models"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "otvm_tpu"}


def test_no_source_imports_jax_or_the_jax_package():
    for path in _py_files():
        assert not set(_top_imports(path)) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for sub in ("reference", "counts"):
        for path in _py_files(sub):
            assert "otvm_tpu_torch" not in set(_top_imports(path)), path


def test_loaded_modules_after_a_cpu_run():
    """The runners, their checks and metrics, loaded and run on the CPU in a
    fresh process, leave no forbidden module in sys.modules; the
    reference and counts alone load nothing of the port."""
    code = f"""
import sys, time, tempfile
sys.path.insert(0, {ROOT!r})
import benchmark.reference.nets, benchmark.reference.stream, benchmark.reference.train
import benchmark.counts.flops, benchmark.checks.stream, benchmark.checks.train
assert not [m for m in sys.modules if m.split('.')[0] == 'otvm_tpu_torch'], 'reference'
from benchmark.tests.conftest import shrink
from benchmark.harness import cells
from benchmark.harness.main import forbidden_modules
for name in ('trimap-stream-1088x1920-fp32',):
    cell = shrink(tempfile.mkdtemp(), name)
    cells.runner(cell).run(cell, seed=1, seconds=0.0, trace=False, t_start=time.time(),
                           device='cpu')
    for m in cell.per_layer:
        cells.metric_reader(cell, m['name'])
print(forbidden_modules(sys.modules))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
