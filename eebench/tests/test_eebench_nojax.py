"""Nothing the benchmark runs imports JAX, the JAX package or the old TPU
records, and the plain reference imports nothing of the program. Modules
are compared by their whole top-level name: the port's name begins with the
JAX package's."""

import ast
import subprocess
import sys

from eebench import harness

ROOT = harness.ROOT
JAX_PACKAGE = "ergodic_exploration_tpu"
PORT = "ergodic_exploration_tpu_torch"


def _imports(path):
    """The top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in (ROOT / "eebench").rglob("*.py"):
        assert not _imports(path) & set(harness.BANNED), path
        text = path.read_text()
        for record in ("BENCH_r0", "MULTICHIP_r0", "bench.py"):
            assert record not in text or path.parent.name == "tests", (path, record)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "eebench" / "reference").rglob("*.py"):
        assert PORT not in _imports(path) and JAX_PACKAGE not in _imports(path), path


def test_whole_name_comparison():
    names = {"ergodic_exploration_tpu_torch.engine", "jaxtyping", "flaxen", "torch"}
    assert not {m.split(".")[0] for m in names} & set(harness.BANNED)
    assert {m.split(".")[0] for m in {"ergodic_exploration_tpu.ops", "jax.numpy"}} \
        & set(harness.BANNED) == {"ergodic_exploration_tpu", "jax"}


def test_a_cell_loads_no_jax():
    """A whole small run on the CPU, in a fresh process: the harness, the
    port and the reference leave no banned module in ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from eebench import harness, program\n"
        "r = harness.run_cell('cart_gmm_replan', 3, 0.1, False, 'cpu', program.port(),\n"
        "                     scale={'scenarios': 4, 'samples': 1})\n"
        "assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(harness.BANNED)))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_without_a_result_where_there_is_no_card_or_no_program(tmp_path):
    """Without CUDA the command exits non-zero and prints nothing on
    standard output; so it does in a directory that holds only the
    benchmark's files."""
    out = subprocess.run([sys.executable, str(ROOT / "eebench" / "run.py"), "--workload",
                          "cart_gmm_replan", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "eebench", tmp_path / "eebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[0] = %r\n"
            "from eebench import program\n"
            "program.port()\n") % str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "ergodic_exploration_tpu_torch" in out.stderr
