"""catseg_tpu_torch imports neither jax, PIL nor anything of catseg_tpu (the
GPU machine has neither jax nor PIL, and the port carries its own copies of
catseg_tpu's host code), reads no file of catseg_tpu, and importing it starts
no kernel build or triton import."""

import ast
import io
import re
import subprocess
import sys
import tokenize
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "catseg_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None   # any "import jax" now raises ImportError
sys.modules["PIL"] = None
sys.modules["catseg_tpu"] = None
import catseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(catseg_tpu_torch.__path__, "catseg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "catseg_tpu_torch.infer.pipeline" in names, names
assert "catseg_tpu_torch.evaluation.miou" in names, names
for m in ("train.loop", "train.optim", "train.checkpoint", "utils.events", "core.dino", "core.sam",
          "core.sam_decoder", "core.fusion", "ops.attention", "infer.sam_predictor", "infer.amg",
          "infer.visualize", "infer.export", "data.image_write", "kernels.ops", "tools.demo", "tools.viz_results",
          "tools.viz_attn", "tools.export", "parallel.mesh", "parallel.latency", "evaluation.distributed",
          "core.mamba"):
    assert "catseg_tpu_torch." + m in names and "catseg_tpu_torch." + m in sys.modules, m
from catseg_tpu_torch.kernels import _build
assert _build._lib is None   # importing built nothing
assert "triton" not in sys.modules
assert not any(m.startswith("catseg_tpu.") for m in sys.modules) and sys.modules["catseg_tpu"] is None
print(len(names))
"""

# a file:line reference to the TPU kernel a port kernel replaces is not a path the port opens
_REFERENCE = re.compile(r"^catseg_tpu/[\w/]+\.py:\d+$")


def test_port_imports_without_jax_or_pil():
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 23


def _py_code_strings(path: Path) -> list[str]:
    """String literals of a Python file that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def _py_code_without_comments(path: Path) -> str:
    toks = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
    return " ".join(t.string for t in toks if t.type not in (tokenize.COMMENT, tokenize.STRING))


def _cu_code(path: Path) -> str:
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return "\n".join(line.split("//")[0] for line in text.splitlines())


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_python_source_opens_no_catseg_tpu_path(path):
    bad = [s for s in _py_code_strings(path) if "catseg_tpu/" in s and not _REFERENCE.match(s)]
    assert not bad, bad
    code = _py_code_without_comments(path)
    assert not re.search(r"\bimport\s+catseg_tpu\b|\bfrom\s+catseg_tpu\b", code)
    assert not re.search(r"\b(jax|PIL)\b", code)


def test_cuda_sources_name_no_catseg_tpu_path():
    for path in sorted((PORT / "csrc").glob("*.cu*")):
        assert "catseg_tpu/" not in _cu_code(path), path
