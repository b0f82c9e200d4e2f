"""The port is complete, held by test.

Read with ``ast`` (nothing of either package is imported for it):
  * every module of ``holoagent_tpu/`` has its counterpart at the same path
    in ``holoagent_tpu_torch/``, and the port's own extra modules are the
    ones ``PORT_ONLY`` names;
  * every public top-level function and class of a module, and every
    public method of such a class, has a counterpart of the same name (a
    function, class, assignment or import at the top of the port's module;
    a method, property or field of the port's class), save the deliberate
    differences ``ALLOWED`` names, each with its reason;
  * every ``pl.pallas_call`` of the JAX package sits in a kernel that
    ``KERNELS`` holds to its CUDA source in ``holoagent_tpu_torch/csrc/``:
    the source defines the C entries, and the port's wrapper of the same
    name launches them and counts its launches.

Then the parity tests of the helpers this test found missing and which are
now ported (the config's ``to_dict`` and ``NavConfig.make``,
``InstanceSet.capacity``, ``clip_dim``, ``Pinhole.matrix`` and ``scaled``,
the transformer's ``init_block_stack`` and ``quantize_block_stack``, SAM's
``init_encoder``, ``init_prompt_encoder`` and ``init_decoder``).
"""

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "holoagent_tpu", ROOT / "holoagent_tpu_torch"

# The port's modules that have no counterpart in the JAX package.
PORT_ONLY = {
    "bridge.py": "weights between the packages, numpy in and out (the tests' and the scripts' bridge)",
    "device.py": "device resolution: the card unless the caller asks for the CPU",
    "dataloader/export.py": "writes rendered frames in each loader's file layout (no dataset ships)",
    "models/sam2.py": "SAM 2.1 with the Hiera encoder as the mapper's segmenter (the JAX package has no SAM 2)",
    "ops/_cuda_build.py": "nvcc builds of csrc/ and their ctypes bindings",
    "ops/mask_head.py": "SAM 2's mask head, a CUDA kernel without a Pallas counterpart (the JAX package has no SAM 2)",
    "ops/resize.py": "jax.image.resize rebuilt as explicit weights",
    "parallel/comm.py": "the collectives in the reference's terms (GSPMD places them in JAX)",
    "parallel/launch.py": "spawns the ranks of a process group (one JAX process drives every device)",
    "utils/timing.py": "per-stage timers on the card (the JAX package times no stage)",
}

# Deliberate differences: "module:name" (a top-level name, or Class.method)
# -> why the port has no counterpart of that name.
ALLOWED = {
    # held by tests/test_torch_mapping.py::test_fused_frame_step_matches_reference
    "memory/mapping.py:frame_step": "an XLA one-program fusion; in torch it is the staged path untiered",
}

# The Pallas kernels: (JAX module, the public function around its
# pl.pallas_call) -> (the port's CUDA source, the C entries its wrapper of
# the same name launches).
KERNELS = {
    ("ops/flash_attention.py", "flash_attention_2d"): (
        "csrc/flash_attention.cu", ("ha_flash_attention_2d", "ha_flash_attention_general")),
    ("ops/flash_attention.py", "flash_attention"): (
        "csrc/flash_attention.cu",
        ("ha_flash_attention_resident", "ha_flash_attention_long", "ha_flash_attention_general")),
    ("ops/quant_matmul.py", "quant_matmul"): ("csrc/quant_matmul.cu", ("ha_quant_matmul",)),
}


def _modules(pkg: Path):
    return sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level(tree: ast.Module):
    """The statements at a module's top, through if/try/with blocks."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            todo += node.body + getattr(node, "orelse", []) + getattr(node, "finalbody", [])
            todo += [s for h in getattr(node, "handlers", []) for s in h.body]
        else:
            yield node


def _assigned(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _definitions(path: Path, fields: bool = True):
    """(functions, {class: members}, every top-level name) of a module; a
    class's members are its methods, and its fields where `fields`."""
    funcs, classes, names = set(), {}, set()
    for node in _top_level(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.add(node.name)
        elif isinstance(node, ast.ClassDef):
            members = set()
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(m.name)
                if fields:
                    members.update(_assigned(m))
            classes[node.name] = members
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        names.update(_assigned(node))
    return funcs, classes, names | funcs | set(classes)


def test_every_module_has_its_counterpart():
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    assert len(jax_mods) > 100
    assert [m for m in jax_mods if m not in port_mods] == []
    assert sorted(set(port_mods) - set(jax_mods)) == sorted(PORT_ONLY)


def test_every_public_name_has_its_counterpart():
    gaps, allowed_seen = [], set()
    for mod in _modules(JAX_PKG):
        jfuncs, jclasses, _ = _definitions(JAX_PKG / mod, fields=False)
        _, pclasses, pnames = _definitions(PORT_PKG / mod)
        wanted = [f for f in jfuncs | set(jclasses) if not f.startswith("_")]
        wanted += [f"{c}.{m}" for c, ms in jclasses.items() if not c.startswith("_") and c in pclasses
                   for m in ms if not m.startswith("_")]
        for name in sorted(wanted):
            cls, _, member = name.partition(".")
            have = member in pclasses[cls] if member else name in pnames
            if have:
                continue
            if f"{mod}:{name}" in ALLOWED:
                allowed_seen.add(f"{mod}:{name}")
            else:
                gaps.append(f"{mod}:{name}")
    assert gaps == []
    # an entry whose name the port now has, or the reference dropped, goes
    assert allowed_seen == set(ALLOWED)


def _pallas_sites():
    """(module, top-level function) around every pl.pallas_call."""
    sites = set()
    for mod in _modules(JAX_PKG):
        for node in _top_level(ast.parse((JAX_PKG / mod).read_text())):
            for call in ast.walk(node):
                if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "pallas_call"):
                    assert isinstance(node, ast.FunctionDef), f"{mod}: pallas_call outside a function"
                    sites.add((mod, node.name))
    return sites


def test_every_pallas_kernel_has_its_cuda_source():
    assert _pallas_sites() == set(KERNELS)
    for (mod, name), (source, entries) in KERNELS.items():
        text = (PORT_PKG / source).read_text()
        port = ast.parse((PORT_PKG / mod).read_text())
        fn = next(n for n in port.body if isinstance(n, ast.FunctionDef) and n.name == name)
        used = {n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}
        used |= {n.value for n in ast.walk(fn) if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        consts = {n.value for n in ast.walk(port) if isinstance(n, ast.Constant)}
        counted = any(isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Attribute) and t.attr == "launches" and getattr(t.value, "id", None) == name
            for t in n.targets) for n in port.body)
        for entry in entries:
            assert re.search(rf'extern "C" [\w\s*]+\b{entry}\(', text), (source, entry)
            assert entry in used, (mod, name, entry)
        assert Path(source).name in consts, (mod, source)
        assert counted, f"{mod}:{name} keeps no launch count"


# ---------------------------------------------------------------------------
# Parity of the ported helpers
# ---------------------------------------------------------------------------


def test_config_to_dict_and_nav_make(monkeypatch):
    from holoagent_tpu import config as jcfg
    from holoagent_tpu import nav as jnav
    from holoagent_tpu_torch import config as tcfg
    from holoagent_tpu_torch import nav as tnav

    over = {"nav": {"controller": "dwb", "critic_params": {"PathAlign.scale": 16.0}}, "main": {"seed": 3}}
    assert tcfg.to_dict(tcfg.from_dict(over)) == jcfg.to_dict(jcfg.from_dict(over))
    calls = {}
    for pkg, nav in (("jax", jnav), ("torch", tnav)):
        monkeypatch.setattr(nav, "make_controller", lambda name, costmap, _p=pkg, **kw: calls.setdefault(_p, [])
                            .append((name, costmap, kw)))
    for ctl in ("dwb", "rpp", "mppi"):
        for cfg in (jcfg.from_dict({**over, "nav": {**over["nav"], "controller": ctl}}),
                    tcfg.from_dict({**over, "nav": {**over["nav"], "controller": ctl}})):
            cfg.nav.make("costmap")
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) == 3
    assert calls["torch"][0][2]["critic_params"] == {"PathAlign.scale": 16.0}


def test_instance_capacity_and_clip_dim():
    from holoagent_tpu.memory import instances as jinst
    from holoagent_tpu.models import clip as jclip
    from holoagent_tpu_torch.memory import instances as tinst
    from holoagent_tpu_torch.models import clip as tclip

    assert tinst.empty_instances(5, 7, 16, "cpu").capacity == tuple(jinst.empty_instances(5, 7, 16).capacity) == (5, 7)
    assert {n: tclip.clip_dim(n) for n in tclip.VARIANTS} == {n: jclip.clip_dim(n) for n in jclip.VARIANTS}


@pytest.mark.parametrize("k", [(525.0, 525.0, 319.5, 239.5), (600.1, 599.7, 321.3, 241.9)])
def test_pinhole_matrix_and_scaled(k):
    from holoagent_tpu.utils.camera import Pinhole as JPinhole
    from holoagent_tpu_torch.utils.camera import Pinhole as TPinhole

    jc, tc = JPinhole.make(*k), TPinhole.make(*k)
    np.testing.assert_array_equal(tc.matrix("cpu").numpy(), np.asarray(jc.matrix()))
    for sx, sy in ((0.5, 0.5), (1 / 3, 0.7), (2.0, 1.25)):
        js, ts = jc.scaled(sx, sy), tc.scaled(sx, sy)
        np.testing.assert_array_equal(np.asarray(ts, np.float32), np.asarray([np.asarray(v) for v in js], np.float32))
        np.testing.assert_array_equal(ts.matrix("cpu").numpy(), np.asarray(js.matrix()))


def _std_close(got: np.ndarray, want: np.ndarray, what: str, tol: float = 0.1):
    """A random leaf's spread against the reference's (values differ by
    design: the seeded init is torch's); a constant leaf exactly."""
    assert got.shape == want.shape, what
    if np.all(want == want.flat[0]):
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif want.size >= 1024:
        assert abs(got.std() / want.std() - 1) < tol, (what, got.std(), want.std())


def test_block_stack_init_and_quantize():
    from holoagent_tpu.models import transformer as jtfm
    from holoagent_tpu_torch.models import transformer as ttfm

    layers, width = 2, 64
    tree = jax.tree.map(np.asarray, jtfm.init_block_stack(jax.random.key(0), layers, width))
    blocks = [ttfm.Block(width, 4 * width) for _ in range(layers)]
    ttfm.init_block_stack(blocks, torch.Generator().manual_seed(0))
    for i, blk in enumerate(blocks):
        for name, p in blk.named_parameters():
            _std_close(p.detach().numpy(), tree[name][i], f"{name}[{i}]", tol=0.05)
    with torch.no_grad():  # the reference's weights into the port's blocks: quantized alike
        for i, blk in enumerate(blocks):
            for name, p in blk.named_parameters():
                p.copy_(torch.from_numpy(np.array(tree[name][i])))
    jq = jax.tree.map(np.asarray, jtfm.quantize_block_stack(tree))
    tq = [ttfm.QBlock(width, 4 * width) for _ in range(layers)]
    ttfm.quantize_block_stack(tq, blocks)
    for i, q in enumerate(tq):
        for name in ttfm.Q8_WEIGHTS:
            np.testing.assert_array_equal(getattr(q, f"{name}_q8").numpy().T, jq[f"{name}_q8"][i], err_msg=name)
            np.testing.assert_array_equal(getattr(q, f"{name}_s").numpy().reshape(-1),
                                          jq[f"{name}_s"][i].reshape(-1), err_msg=name)
        for name in ("ln1_g", "ln1_b", "bqkv", "bo", "ln2_g", "ln2_b", "b1", "b2"):
            np.testing.assert_array_equal(getattr(q, name).numpy(), jq[name][i], err_msg=name)


def test_sam_init_parts():
    """init_encoder, init_prompt_encoder and init_decoder, each on its part
    of an uninitialized SAM: the reference's leaves, shapes and scales."""
    from holoagent_tpu.models import sam as jsam
    from holoagent_tpu_torch import bridge
    from holoagent_tpu_torch.models import sam as tsam

    v = "fixture-tiny"
    want = bridge.flatten(jax.tree.map(np.asarray, jsam.init_sam(jax.random.key(0), jsam.VARIANTS[v],
                                                                 dtype=jnp.float32)))
    sam = tsam.SAM(tsam.VARIANTS[v], device="cpu")
    gen = torch.Generator().manual_seed(0)
    assert tsam.init_encoder(sam.encoder, gen) is sam.encoder
    assert tsam.init_prompt_encoder(sam.prompt, gen) is sam.prompt
    assert tsam.init_decoder(sam.decoder, gen) is sam.decoder
    got = bridge.flatten(bridge.sam_to_numpy(sam))
    assert set(got) == set(want)
    for k in want:
        _std_close(got[k], want[k], k)
    # init_sam is the three parts from one generator
    whole = tsam.init_sam(tsam.VARIANTS[v], seed=0, device="cpu").state_dict()
    for k, t in sam.state_dict().items():
        assert torch.equal(t, whole[k]), k
