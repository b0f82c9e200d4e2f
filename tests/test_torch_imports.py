"""The port stands alone: holoagent_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, nor transformers (the card machine has
none; tests may use it for reference weights), nor PyYAML (which the card
machine lacks) outside the one function that reads a YAML config; and an
entry point not asked for the CPU refuses to run without CUDA."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import holoagent_tpu_torch
from holoagent_tpu_torch import device as tdevice
from holoagent_tpu_torch.apps import (batch_map, build_map, eval_protocol, long_query_bench, query_bench,
                                      retrieval_bench, serving_bench)
from holoagent_tpu_torch.apps.common import load_dataset, load_models, tokenizer
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.memory import checkpoint as tckpt
from holoagent_tpu_torch.memory.hmsg import HMSGraph
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.models import vlm as tvlm
from holoagent_tpu_torch.ops import solvers as tsolvers
from holoagent_tpu_torch.ops.voxel import GridSpec
from holoagent_tpu_torch.perception.oracle import oracle_frame_features
from holoagent_tpu_torch.query import FSRQueryEngine, LLMParser
from holoagent_tpu_torch.query import llm_client
from holoagent_tpu_torch.utils.camera import Pinhole

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(holoagent_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "holoagent_tpu", "yaml", "transformers")


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
    assert int(r.stdout.strip()) >= 40


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
    for entry in (lambda: eval_protocol.run_one(0), lambda: eval_protocol.run(seeds=1, neural=False),
                  lambda: query_bench.run("no-graph", [], cfg), lambda: long_query_bench.run("no-graph", "", cfg),
                  lambda: oracle_frame_features(np.zeros((4, 4), np.int32), np.zeros((4, 4), np.int32), ["a"], 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    for entry in (lambda: tckpt.load_mapper_state("no-state.pt"), lambda: tckpt.load_params("no-params.pt"),
                  lambda: tsam.convert_sam({}, tsam.VARIANTS["test-tiny"]),
                  lambda: tclip.convert_open_clip({}, tclip.VARIANTS["test-tiny"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    tv = tvlm.VARIANTS["test-tiny"]
    for entry in (lambda: tvlm.init_vlm(tv), lambda: tvlm.init_cache(tv, 2), lambda: tvlm.VLM(tv),
                  lambda: serving_bench.run("test-tiny")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    assert tdevice.resolve("cpu").type == "cpu"


def test_seventh_slice_entry_points_raise_without_cuda(monkeypatch):
    """The dataset loaders' entry, batch_map, retrieval_bench and the pose
    solvers run on the card unless asked for the CPU; llm_client and
    LLMParser are host-side and device-free."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = from_dict({"main": {"dataset": "synthetic", "num_frames": 2, "frame_h": 8, "frame_w": 8},
                     "models": {"clip": {"type": "test-tiny", "dtype": "float32"},
                                "sam": {"type": "test-tiny", "dtype": "float32"}}})
    eye, pts = np.eye(4, dtype=np.float32), np.zeros((4, 3), np.float32)
    cam = Pinhole.make(10.0, 10.0, 4.0, 4.0)
    for entry in (lambda: load_dataset(cfg), lambda: batch_map.run_batch(cfg, []),
                  lambda: retrieval_bench.main(["--gallery", "8", "--batch", "2"]),
                  lambda: tsolvers.pnp_gauss_newton(pts, pts[:, :2], np.ones(4, bool), cam, eye),
                  lambda: tsolvers.pnp_batch(pts[None], pts[None, :, :2], np.ones((1, 4), bool), cam, eye[None]),
                  lambda: tsolvers.pose_graph_gauss_newton(eye[None], np.zeros((0, 2)), np.zeros((0, 4, 4)),
                                                           np.zeros(0, bool)),
                  lambda: tsolvers.icp_point2point(pts, np.ones(4, bool), np.zeros(1, np.int32), pts[:1],
                                                   GridSpec.centered(0.1), eye),
                  lambda: tsolvers.icp_multiscale(pts, np.ones(4, bool), pts, np.ones(4, bool), eye)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    assert len(load_dataset(cfg, "cpu")) == 2
    assert batch_map.run_batch(cfg, [], device="cpu") == {}
    client = llm_client.CachedLLMClient(lambda messages: "[Floor 1, Kitchen, sink]")
    parsed = LLMParser(lambda system, prompt: client.send_query(
        llm_client.Conversation().system(system).user(prompt)))("the sink in the kitchen on floor 1")
    assert parsed.astuple() == ("Floor 1", "Kitchen", "sink")


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
