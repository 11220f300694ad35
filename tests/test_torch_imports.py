"""The port and the scripts that run it on the card import neither JAX nor
the reference."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD_SCRIPTS = ("chip_smoke.py", "kernel_ab.py", "kernel_phases.py", "mma_peak.py")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / f for f in CARD_SCRIPTS]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_roots(path) if m in BANNED})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    assert len(FILES) > 20 and all((ROOT / f).exists() for f in CARD_SCRIPTS)


@pytest.mark.parametrize("part", ["training", "data", "checkpoint",
                                  "launch/train.py", "distributed"])
def test_scan_covers_the_training_slice(part):
    path = ROOT / "src" / "repro_torch" / part
    found = [f for f in FILES if f == path or path in f.parents]
    assert found, part
