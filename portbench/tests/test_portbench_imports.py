"""What the chip path loads, compared by whole top-level module names
(the port's name begins with the JAX package's), and a run without a
card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sednet_tpu"}


def _top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _loaded_after(code: str) -> set:
    probe = (code + "\nimport sys, json\n"
             "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_chip_path_loads_no_jax_and_no_jax_package():
    loaded = _loaded_after(
        "from portbench import run\n"
        "import sednet_tpu_torch.predict, sednet_tpu_torch.train\n"
        "for k in ('eval', 'train'): run.kind_module(k)\n"
        "import glob, os\n"
        "for f in glob.glob('portbench/metrics/*.py'):\n"
        "    run.load_module(__import__('pathlib').Path(f))")
    assert "sednet_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_no_file_of_the_benchmark_names_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "gen.py", "counts.py"):
        assert "sednet_tpu_torch" not in _top_level_imports(HERE / name)
    loaded = _loaded_after("import portbench.reference, portbench.gen, "
                           "portbench.counts")
    assert not loaded & (FORBIDDEN | {"sednet_tpu_torch"})


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "sednet_normal.eval_10k", "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
