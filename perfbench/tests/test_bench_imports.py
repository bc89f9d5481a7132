"""What the harness and the reference may import."""
import ast
import subprocess
import sys

from perfbench import common, harness

SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import perfbench.reference.train, perfbench.reference.serve
import perfbench.reference.model, perfbench.reference.hashing
ref = sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch')
sys.path.insert(0, {tests!r})
import tiny
tiny.run(tiny.train_cell())
tiny.run(tiny.serve_cell(), trace=True)
print(ref, sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_banned_names_compared_whole():
    assert harness.banned_modules(["repro_torch", "repro_torch.models",
                                   "reprox"]) == []
    assert harness.banned_modules(["repro.models", "jax", "flax.linen",
                                   "jaxlib.x"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]


def test_runs_load_no_jax_and_reference_loads_no_port():
    code = SCRIPT.format(root=str(common.ROOT), src=str(common.ROOT / "src"),
                         tests=str(common.HERE / "tests"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    ref_port, tops = r.stdout.strip().splitlines()[-1].split("] [")
    assert ref_port == "["
    names = {n.strip(" '[]") for n in tops.split(",")}
    assert not names & set(harness.BANNED_MODULES)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_reference_no_port():
    for path in common.HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.BANNED_MODULES), path
        if path.parent.name == "reference" or path.name in (
                "weights.py", "traffic.py", "roofline.py", "checks.py",
                "common.py"):
            assert "repro_torch" not in tops, path
