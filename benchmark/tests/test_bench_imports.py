"""The import check, and what the benchmark loads: nothing of JAX or of the
JAX package, compared by whole top-level names, and nothing of the program
in the yardstick; without a card, or without the program, a run prints no
result and exits non-zero."""

import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]


def test_the_check_compares_whole_top_level_names():
    loaded = {"jax.numpy": 1, "tpualign_torch.api": 1, "tpualign_torchx": 1, "numpy": 1}
    assert harness.forbidden_modules(loaded) == ["jax"]
    assert harness.forbidden_modules({"tpualign.ops.band": 1, "jaxlib": 1, "flax.linen": 1}) \
        == ["flax", "jaxlib", "tpualign"]
    assert harness.forbidden_modules({"tpualign_torch": 1, "jaxtyping": 1}) == []


def test_the_yardstick_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from benchmark import harness, roofline, spec, trace, traffic, control; "
            "from benchmark.reference import linear, alignment; "
            "s = spec.load(); [spec.workload(s, w['name']) for w in s['workloads']]; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpualign', 'tpualign_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sw.pair64gb.score",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_with_only_the_benchmark_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
