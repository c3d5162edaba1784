"""The PyTorch port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports jax or any module of the JAX package ``repro``
(checked on the syntax tree, so imports inside functions count too)."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_check_sees_the_whole_port():
    assert len(FILES) > 20 and REPO / "chip_smoke.py" in FILES
    port = REPO / "src" / "repro_torch"
    for mod in ("parallel/sharding.py", "parallel/pipeline.py",
                "train/train_step.py", "train/elastic.py",
                "train/checkpoint.py", "optim/compress.py",
                "core/affinity.py", "core/op_cost.py", "core/sweep.py",
                "launch/sweep.py", "launch/mesh.py", "benchmarks/pinning.py",
                "launch/dryrun.py", "launch/report.py", "core/autotune.py"):
        assert port / mod in FILES, mod
    # the detector itself: the parity tests do import the JAX package
    assert "repro.models" in set(_imported(REPO / "tests" / "test_torch_model.py"))
