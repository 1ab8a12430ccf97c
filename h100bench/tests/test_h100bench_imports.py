"""Nothing the harness runs imports JAX or the JAX package (top-level
module names compared whole: guetzli_tpu is not guetzli_tpu_torch), by
its sources and in a process that has run it."""

import ast
import json
import subprocess
import sys

from h100bench.tests import minibench

FORBIDDEN = {"jax", "jaxlib", "flax", "guetzli_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_no_jax():
    files = [p for p in minibench.BENCH.rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run (on the CPU) in a fresh process: sys.modules then
    holds none of the forbidden top-level names."""
    bench_args = json.dumps(str(tmp_path))
    code = (
        "import json, pathlib, sys, time\n"
        "sys.path.insert(0, %r)\n"
        "from h100bench.tests import minibench\n"
        "from h100bench.lib import cell\n"
        "b, root, d = minibench.make(pathlib.Path(json.loads(%r)))\n"
        "res, _ = cell.run_cell(b, 'serial444', 3, 0.01, False,\n"
        "                       time.perf_counter(), device='cpu',\n"
        "                       root=root, bench_dir=d, warm=False)\n"
        "assert res['correct'], res\n"
        "print(json.dumps(cell.forbidden_modules()))\n"
        % (str(minibench.ROOT), bench_args))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_exits_without_a_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "png444_q95.photo_serial", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(minibench.ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""
