"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
top-level name, whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "clipcap_tpu"}
PORT = "clipcap_tpu_torch"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_sources_name_no_forbidden_module():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        tops = imported_tops(f)
        assert not tops & FORBIDDEN, f"{f} imports {sorted(tops & FORBIDDEN)}"
        if "reference" in f.relative_to(BENCH).parts:
            assert PORT not in tops, f"{f} imports the port"


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_rehearsed_run_loads_no_forbidden_module():
    loaded = _loaded_after(
        "from benchmark.tests.tiny import serving_context\n"
        "from benchmark import run as B\n"
        "B.run_cell(serving_context(seconds=0.5, trace=True))")
    assert PORT in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(
        "from benchmark.tests.tiny import serving_context, beam_context\n"
        "from benchmark.reference import serving, beam\n"
        "ctx = serving_context()\n"
        "res = {i: {'tokens': [3, 4, 13]} for i in range(4)}\n"
        "v = serving.judge(ctx, res, {i: 5 for i in res}, {i: i for i in res}, control_bits=4)\n"
        "assert v['requests_judged'] == 4\n"
        "import torch\n"
        "ctx = beam_context()\n"
        "n = ctx.traffic['images']\n"
        "out = {'tokens': torch.ones(n, 5, 6, dtype=torch.int32),\n"
        "       'seq_lengths': torch.full((n, 5), 6, dtype=torch.int32),\n"
        "       'scores': torch.zeros(n, 5)}\n"
        "want = min(ctx.traffic['judge_images'], 2 * n)\n"
        "assert beam.judge(ctx, [out, out], 2)['images_judged'] == want")
    assert not loaded & (FORBIDDEN | {PORT}), sorted(loaded & (FORBIDDEN | {PORT}))
