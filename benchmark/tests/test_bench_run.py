"""One short drive of the whole run on the CPU at the tiny configuration,
and the run's refusals."""
import ast
import asyncio
import os
import subprocess
import sys
from pathlib import Path

from benchmark import run as bench_run
from benchmark.tests.conftest import ROOT


def _run(bench, mix, trace=False, seed=2**31 + 7, seconds=3.0):
    return asyncio.run(bench_run.run_cell("tiny-chat", seed, seconds, trace, "cpu", bench,
                                          mix=mix, log=lambda *a: None))


def test_cpu_drive_is_correct_and_reports_no_device_metric(tiny):
    bench, mix = tiny
    res, run, verdict = _run(bench, mix)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 6
    assert set(res["metrics"]) == {"ttfa_p50_ms", "stream_rtf_p10", "audio_s_per_s",
                                   "audio_s_per_s.clone", "setup_s"}
    assert res["metrics"]["audio_s_per_s"] == res["metrics"]["audio_s_per_s.clone"]
    assert list(res)[-1] == "checks" and res["device"]["platform"] == "cpu"
    assert verdict["detail"]["greedy_tokens"] >= 30 and verdict["detail"]["pcm_hops"] > 0
    for r in run.records:
        assert len(r["hops"]) == r["item"].frames and len(r["tokens"]) == r["item"].max_tokens
    res2, _, _ = _run(bench, mix, trace=True)
    # on the CPU the traced run reads host numbers only: no device metric
    assert set(res2["metrics"]) <= {"dispatch_host_ms"} and "busy_s" not in res2["device"]


def test_run_refuses_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line; the same in a
    directory that holds only BENCHMARK.json and the benchmark."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for root in (ROOT, tmp_path):
        if root is tmp_path:
            (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
            subprocess.run(["cp", "-r", str(ROOT / "benchmark"), str(tmp_path / "benchmark")],
                           check=True)
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "smollm2-chat-greedy", "--seed", "1", "--seconds", "1",
                            "--trace", "0"], cwd=root, env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "project_morpheus_tpu"}


def _imports(path: Path, root: Path = ROOT):
    """The modules a file imports, a relative import resolved against the
    file's package under ``root``."""
    tree = ast.parse(path.read_text())
    package = path.relative_to(root).parent.parts
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package[:len(package) - node.level + 1])
            if node.module:
                yield f"{base}.{node.module}"
            else:
                yield from (f"{base}.{a.name}" for a in node.names)
    for node in ast.walk(tree):  # importlib by name
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for a in node.args:
                if isinstance(a, ast.Constant):
                    yield a.value


def _program_imports(path: Path, root: Path = ROOT):
    """What a file imports of the program: the port, or a module of the
    benchmark that imports it (``lib/program.py``, ``lib/trace.py``, a
    family's ``program.py``)."""
    for name in _imports(path, root):
        parts = name.split(".")
        if parts[0] == "project_morpheus_tpu_torch" or name in (
                "benchmark.lib.program", "benchmark.lib.trace") or (
                parts[:2] == ["benchmark", "families"] and parts[-1] == "program"):
            yield name


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, f"{f}: imports {name}"


def test_reference_and_yardstick_import_nothing_of_the_program():
    families = ROOT / "benchmark" / "families"
    own = [*(ROOT / "benchmark" / "reference").glob("*.py"),
           *(ROOT / "benchmark" / "lib" / n for n in ("traffic.py", "stats.py", "counts.py",
                                                      "weights.py", "spec.py", "check.py")),
           *families.glob("*/weights.py"), *families.glob("*/reference.py"),
           *families.glob("*/counts.py")]
    assert len(list(families.glob("*/reference.py"))) >= 1
    for f in own:
        assert list(_program_imports(f)) == [], f


def test_import_guard_sees_a_family_file_reach_its_program(tmp_path):
    """A reference that takes from its family's ``program.py`` by a
    relative import is caught as an import of the program."""
    fam = tmp_path / "benchmark" / "families" / "planted"
    fam.mkdir(parents=True)
    for plant in ("from .program import engine_inputs\n", "from . import program\n",
                  "from ..llama.program import engine_inputs\n"):
        ref = fam / "reference.py"
        ref.write_text((ROOT / "benchmark/families/llama/reference.py").read_text() + plant)
        assert list(_program_imports(ref, tmp_path)), plant
    ref.write_text((ROOT / "benchmark/families/llama/reference.py").read_text()
                   + "from .weights import dims\n")
    assert list(_program_imports(ref, tmp_path)) == []


def test_run_leaves_no_jax_loaded():
    """A whole run in a fresh process loads no JAX module."""
    code = ("import sys, asyncio; sys.path.insert(0, %r); from benchmark import run; "
            "from benchmark.tests.conftest import tiny_bench, tiny_mix; "
            "asyncio.run(run.run_cell('tiny-chat', 3, 1.0, False, 'cpu', tiny_bench(), "
            "mix=tiny_mix(), log=lambda *a: None)); print(run.forbidden_modules())") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
