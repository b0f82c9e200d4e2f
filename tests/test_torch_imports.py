"""The port stands alone: holoagent_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package (nor PyYAML, which the card machine lacks,
outside the one function that reads a YAML config), and an entry point not
asked for the CPU refuses to run without CUDA."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import holoagent_tpu_torch
from holoagent_tpu_torch import device as tdevice
from holoagent_tpu_torch.apps import build_map
from holoagent_tpu_torch.apps.common import load_models, tokenizer
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.memory.hmsg import HMSGraph
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.query import FSRQueryEngine

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(holoagent_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "holoagent_tpu", "yaml")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


LAZY_YAML = {("config.py", "load")}  # (file, function) that may import yaml inside


def _imports(tree, path):
    """(file, function or None, imported module) of every import."""
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Import):
                out.extend((path.name, fn, a.name) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                out.append((path.name, fn, child.module))
            visit(child, inner)

    visit(tree, None)
    return out


def test_no_forbidden_import_in_the_source():
    bad = []
    for path in _port_sources():
        for file, fn, name in _imports(ast.parse(path.read_text(), str(path)), path):
            if _forbidden(name) and not (name == "yaml" and (file, fn) in LAZY_YAML):
                bad.append((file, fn, name))
    assert not bad, bad


def test_imports_with_jax_blocked():
    """Import every module of the port, and chip_smoke, in a process where
    `import jax`, `import holoagent_tpu` and `import yaml` fail."""
    code = (
        "import sys, importlib, pkgutil\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import holoagent_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'holoagent_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 35


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve()
    with pytest.raises(RuntimeError):
        tclip.CLIPVisual(tclip.VARIANTS["test-tiny"])
    with pytest.raises(RuntimeError):
        tsam.init_sam(tsam.VARIANTS["test-tiny"])
    clip = tclip.init_clip_visual(tclip.VARIANTS["test-tiny"], device="cpu")
    sam = tsam.init_sam(tsam.VARIANTS["test-tiny"], device="cpu")
    cfg = from_dict({"models": {"clip": {"type": "test-tiny", "dtype": "float32"}, "sam": {"type": "test-tiny"}}})
    with pytest.raises(RuntimeError):
        Mapper(cfg, clip, sam)
    with pytest.raises(RuntimeError):
        load_models(cfg)
    with pytest.raises(RuntimeError):
        build_map.run(cfg)
    text = tclip.CLIPText(tclip.VARIANTS["test-tiny"], device="cpu")
    with pytest.raises(RuntimeError):
        FSRQueryEngine(HMSGraph(), text, tokenizer())
    assert FSRQueryEngine(HMSGraph(), text, tokenizer(), device="cpu").device.type == "cpu"
    assert tdevice.resolve("cpu").type == "cpu"


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """No CUDA here: exit non-zero with no result line; a directory holding
    only chip_smoke.py fails as well."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=300,
                       env=env, cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
