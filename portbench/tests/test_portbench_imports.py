"""No module portbench runs loads JAX or the JAX package, and the reference
stands apart from the program. Names are compared whole by their top-level
part: magicdec_tpu_torch begins with magicdec_tpu but is not it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not _imported_tops(path) & {"jax", "jaxlib", "flax", "magicdec_tpu"}


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imported_tops(path) <= {"__future__", "math", "torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "magicdec_tpu_torch_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "magicdec_tpu.models", object())
    assert run.forbidden_modules() == ["magicdec_tpu"]


def test_the_yardstick_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.check, portbench.roofline, portbench.trace\n"
            "from portbench.metrics import reader\n"
            "import json\n"
            "b = json.load(open(%r))\n"
            "[reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'jax', 'magicdec_tpu', 'magicdec_tpu_torch'})\n"
            "print(bad)" % (str(PKG.parent), str(PKG.parent / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
