"""The port's multi-device layer (parallel/*, topk_cosine_sharded,
prefill_sp, the batcher with a mesh, the DP+TP contrastive step) against the
JAX package on the CPU.

The port runs as 4 gloo ranks (``parallel.launch.spawn``), spawned once for
the module: the fixture writes the numpy inputs, every rank runs every case
of ``_torch_dist_ranks`` (jax-free), and the results come back as numpy.
The JAX side runs on ``jax.devices()[:4]`` of conftest's 8 host devices, as
a (4, 1) mesh, a (2, 2) mesh for TP, or a 4-device "stage" / "expert" axis.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_dist_ranks as ranks
from holoagent_tpu.config import MeshConfig
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import transformer as jtfm
from holoagent_tpu.models import vlm as jvlm
from holoagent_tpu.ops import retrieval as jret
from holoagent_tpu.parallel import make_mesh, shard_params
from holoagent_tpu.parallel import moe as jmoe
from holoagent_tpu.parallel import pipeline as jpipe
from holoagent_tpu.parallel.ring_attention import ring_attention
from holoagent_tpu.parallel.sharding import _BLOCK_SPECS
from holoagent_tpu.serving.batcher import ContinuousBatcher as JBatcher
from holoagent_tpu.training import contrastive as jcon
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.parallel import launch
from test_torch_training import GRAD_TOL, _close_trees

W = 4
CASES = ["mesh", "sharding", "ring", "pipeline", "moe", "topk", "prefill_sp", "batcher", "train_step"]
STEP_TOL = 1e-5  # abs, parameters after one AdamW step (tests/test_torch_training.py)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(data=-1, model=1):
    return make_mesh(MeshConfig(data=data, model=model), jax.devices()[:W])


def _axis(name):
    return Mesh(np.array(jax.devices()[:W]), (name,))


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    clip_tree = _np(jclip.init_clip(jax.random.key(0), jclip.VARIANTS["test-tiny"], dtype=jnp.float32))
    inp["sharding"] = {"tree": clip_tree, "variant": "test-tiny"}
    inp["ring"] = {n: rng.normal(0, 1, (1, 2, 16 * W, 32)).astype(np.float32) for n in "qkv"}

    def stages(key, n, d):
        return [{"w": np.asarray(jax.random.normal(k, (d, d), jnp.float32) * 0.3), "b": np.zeros((d,), np.float32)}
                for k in jax.random.split(key, n)]

    def blocks(key, n, width=32):
        out = []
        for k in jax.random.split(key, n):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            out.append({n_: np.asarray(a, np.float32) for n_, a in {
                "ln1_g": jnp.ones((width,)), "ln1_b": jnp.zeros((width,)),
                "wqkv": jax.random.normal(k1, (width, 3 * width)) * 0.2, "bqkv": jnp.zeros((3 * width,)),
                "wo": jax.random.normal(k2, (width, width)) * 0.2, "bo": jnp.zeros((width,)),
                "ln2_g": jnp.ones((width,)), "ln2_b": jnp.zeros((width,)),
                "w1": jax.random.normal(k3, (width, 4 * width)) * 0.2, "b1": jnp.zeros((4 * width,)),
                "w2": jax.random.normal(k4, (4 * width, width)) * 0.2, "b2": jnp.zeros((width,)),
            }.items()})
        return out

    inp["pipeline"] = {
        "mlp": {"stages": stages(jax.random.key(0), W, 16),
                "x": np.asarray(jax.random.normal(jax.random.key(1), (8, 5, 16), jnp.float32))},
        "mlp_m1": {"stages": stages(jax.random.key(2), W, 8),
                   "x": np.asarray(jax.random.normal(jax.random.key(3), (1, 3, 8), jnp.float32))},
        "blocks": {"stages": blocks(jax.random.key(4), W),
                   "x": np.asarray(jax.random.normal(jax.random.key(5), (4, 2, 6, 32), jnp.float32))},
    }
    moe = {}
    for name, (e, d, dh, t, cf, seed) in {"under_capacity": (8, 16, 32, 24, 8.0, 0),
                                          "two_experts_a_rank": (16, 8, 16, 32, 8.0, 3),
                                          "drops": (8, 8, 16, 64, 0.25, 6),
                                          "drops_full": (8, 8, 16, 64, 16.0, 6)}.items():
        params = _np(jmoe.init_moe_mlp(jax.random.key(seed), e, d, dh))
        if name.startswith("drops"):  # a gate that sends every token to expert 0: overflow at low capacity
            gate_w = np.zeros((d, e), np.float32)
            gate_w[:, 0] = 1.0
            x = np.abs(np.asarray(jax.random.normal(jax.random.key(seed + 1), (t, d), jnp.float32)))
        else:
            gate_w = np.asarray(jax.random.normal(jax.random.key(seed + 1), (d, e)) * 0.5, np.float32)
            x = np.asarray(jax.random.normal(jax.random.key(seed + 2), (t, d), jnp.float32))
        moe[name] = {"params": params, "gate_w": gate_w, "x": x, "cf": cf}
    inp["moe"] = moe
    g = rng.normal(size=(64 * W, 32)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    g[7] = g[200]  # an exact tie across shards
    q = rng.normal(size=(6, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = g[200]
    inp["topk"] = {"g": g, "valid": rng.uniform(size=64 * W) > 0.2, "q": q, "k": 5}
    inp["topk"]["valid"][[7, 200]] = True
    vlm = {name: _np(jvlm.init_vlm(jax.random.key(seed), jvlm.VARIANTS[name], dtype=jnp.float32))
           for name, seed in (("test-tiny", 0), ("test-tiny-llama", 11))}
    emb = {name: np.asarray(jax.random.normal(jax.random.key(5 + i), (2, 8 * W, jvlm.VARIANTS[name].width)) * 0.1,
                            np.float32) for i, name in enumerate(vlm)}
    vlen = {"test-tiny": np.asarray([8 * W, 8 * W - 3], np.int32), "test-tiny-llama": np.asarray([8 * W, 8 * W - 5],
                                                                                                   np.int32)}
    inp["prefill_sp"] = {"vlm": vlm, "emb": emb, "vlen": vlen}
    inp["batcher"] = {"vlm": vlm, "clip": _np(jclip.init_clip(jax.random.key(1), jclip.VARIANTS["test-tiny"])),
                      "prompt": "find the chair near the window in the living room please"}
    imgs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 400, (4, 77)).astype(np.int32)
    toks[:, 12] = 49407  # <eot>
    toks[:, 13:] = 0
    inp["train_step"] = {"tree": clip_tree, "variant": "test-tiny", "imgs": imgs, "toks": toks, "lr": 1e-3,
                         "sgd_lr": 1.0, "steps": 1}
    return inp


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """(inputs, per-rank results) of every case, from one spawn of W ranks."""
    inp = _inputs()
    path = os.path.join(tmp_path_factory.mktemp("dist"), "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return inp, launch.spawn(ranks.run_cases, W, "cpu", args=(path, CASES))


def _same_on_every_rank(results, case):
    flat = [bridge.flatten({"r": r[case]}) if isinstance(r[case], dict) else r[case] for r in results]
    for other in flat[1:]:
        if isinstance(other, dict):
            for k, a in flat[0].items():
                np.testing.assert_array_equal(np.asarray(other[k]), np.asarray(a), err_msg=k)
        else:
            assert repr(other) == repr(flat[0])


def test_make_mesh_rules_and_errors(port):
    _, res = port
    for model in (1, 2, 4):
        assert res[0]["mesh"][f"shape_{model}"] == tuple(_jmesh(model=model).devices.shape)
    assert [r["mesh"]["coords_2"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for data, model in ((-1, 3), (3, 1)):
        with pytest.raises(ValueError) as e:
            _jmesh(data, model)
        assert res[0]["mesh"][f"error_{data}_{model}"] == str(e.value)


def test_sharding_table_and_local_shards(port):
    """The port's placements follow the reference's table leaf for leaf, and
    each rank's local shard equals the reference's shard on the device at
    the same (data, model) position of a 2x2 mesh."""
    inp, res = port
    mesh = _jmesh(model=2)
    tree = inp["sharding"]["tree"]
    placed = shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    dev_of_rank = list(mesh.devices.reshape(-1))
    for rank, r in enumerate(res):
        out = r["sharding"]
        for tower in ("visual", "text"):
            for name, leaf in placed[tower].items():
                if name == "blocks":
                    for bk, arr in leaf.items():
                        shard = next(s.data for s in arr.addressable_shards if s.device == dev_of_rank[rank])
                        for i in range(shard.shape[0]):
                            np.testing.assert_array_equal(out["local"][f"{tower}.blocks.{i}.{bk}"], np.asarray(shard[i]))
                            spec = _BLOCK_SPECS[bk]
                            want = ["Shard(dim=%d)" % (spec.index("model") - 1) if "model" in spec else "Replicate()"]
                            assert out["rule"][f"{tower}.blocks.{i}.{bk}"] == ["Replicate()"] + want
                else:
                    np.testing.assert_array_equal(out["local"][f"{tower}.{name}"], np.asarray(leaf))
                    assert out["rule"][f"{tower}.{name}"] == ["Replicate()", "Replicate()"]
    assert res[0]["sharding"]["data_sharding"] == ["Shard(dim=0)", "Replicate()"]
    assert res[0]["sharding"]["replicated"] == ["Replicate()", "Replicate()"]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(port, causal):
    inp, res = port
    want = ring_attention(*(jnp.asarray(inp["ring"][n]) for n in "qkv"), _jmesh(), causal=causal)
    for r in res:
        np.testing.assert_allclose(r["ring"][causal], np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", ["mlp", "mlp_m1", "blocks"])
def test_pipeline_matches_sequential(port, case):
    """Bit-equal to the port's sequential stack; the reference's
    pipeline_apply within its tests' tolerance."""
    inp, res = port
    c = inp["pipeline"][case]
    if case == "blocks":
        def fn(p, h):
            return jtfm.block(h, p, 4)
        tol = 2e-4
    else:
        def fn(p, h):
            return jnp.tanh(h @ p["w"] + p["b"])
        tol = 1e-5
    want = jpipe.pipeline_apply(fn, jpipe.stack_stages([jax.tree.map(jnp.asarray, s) for s in c["stages"]]),
                                jnp.asarray(c["x"]), _axis("stage"))
    for r in res:
        got, seq = r["pipeline"][case]
        np.testing.assert_array_equal(got, seq)
        np.testing.assert_allclose(got, np.asarray(want), atol=tol)


@pytest.mark.parametrize("case", ["under_capacity", "two_experts_a_rank", "drops", "drops_full"])
def test_moe_matches_reference(port, case):
    inp, res = port
    c = inp["moe"][case]
    want = jmoe.moe_apply(jax.tree.map(jnp.asarray, c["params"]), jnp.asarray(c["gate_w"]), jnp.asarray(c["x"]),
                          _axis("expert"), top_k=2, capacity_factor=c["cf"])
    for r in res:
        got, dense = r["moe"][case]
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
        assert np.isfinite(got).all()
        if case == "drops":  # the drops are the only divergence from the dense combination
            assert float(np.abs(got - dense).max()) > 1e-6
        else:
            np.testing.assert_allclose(got, dense, atol=1e-4)


def test_topk_cosine_sharded(port):
    inp, res = port
    c = inp["topk"]
    ws, wi = jret.topk_cosine_sharded(jnp.asarray(c["g"]), jnp.asarray(c["valid"]), jnp.asarray(c["q"]), c["k"],
                                      _jmesh())
    for r in res:
        (s, i), (ds, di) = r["topk"]["sharded"], r["topk"]["dense"]
        np.testing.assert_array_equal(i, np.asarray(wi))
        np.testing.assert_array_equal(i, di)
        np.testing.assert_allclose(s, np.asarray(ws), atol=1e-6)
    assert res[0]["topk"]["sharded"][1][0, 0] == 7  # the tie across shards goes to the lower index


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-llama"])
def test_prefill_sp_matches_reference(port, name):
    """Logits and the cache against the reference's prefill_sp (tests/
    test_vlm.py's 2e-4), against the port's own prefill, and decode from the
    cache; every rank returns the same."""
    inp, res = port
    c = inp["prefill_sp"]
    v = jvlm.VARIANTS[name]
    emb, vlen = jnp.asarray(c["emb"][name]), jnp.asarray(c["vlen"][name])
    logits, cache = jvlm.prefill_sp(jax.tree.map(jnp.asarray, c["vlm"][name]), emb, vlen, v, _jmesh(),
                                    dtype=jnp.float32)
    t = emb.shape[1]
    for r in res:
        got = r["prefill_sp"][name]
        np.testing.assert_allclose(got["logits"], np.asarray(logits), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got["k"], np.asarray(cache.k[:, :, :t]), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got["v"], np.asarray(cache.v[:, :, :t]), atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(got["length"], np.asarray(vlen))
        np.testing.assert_allclose(got["logits"], got["ref_logits"], atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got["k"], got["ref_k"], atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got["decode"], got["ref_decode"], atol=2e-4, rtol=2e-4)
    _same_on_every_rank(res, "prefill_sp")


def test_batcher_with_a_mesh(port):
    """Prompts over sp_threshold prefill sequence-parallel; the generated
    text equals the batcher's without a mesh and the reference batcher's
    with its mesh."""
    inp, res = port
    c = inp["batcher"]
    jb = JBatcher(jax.tree.map(jnp.asarray, c["vlm"]["test-tiny"]), jax.tree.map(jnp.asarray, c["clip"]),
                  jvlm.VARIANTS["test-tiny"], max_batch=2, dtype=jnp.float32, mesh=_jmesh(), sp_threshold=4)
    want = jb.generate(c["prompt"], max_new_tokens=5)
    for r in res:
        assert r["batcher"]["sp"] == r["batcher"]["plain"] == want


@pytest.mark.parametrize("layout", ["dp", "dp_tp", "dp_sgd"])
def test_mesh_train_step(port, layout):
    """DP over a (4, 1) mesh and DP+TP over a (2, 2) mesh: the step's loss
    equals the reference step's and the port's single-device step's; the
    gradients the optimizer stepped on equal the reference's jax.grad within
    tests/test_torch_training.py's GRAD_TOL (logit_scale's too: every data
    rank holds its whole gradient); every rank holds the same parameters.
    AdamW's new parameters equal the single-device step's within STEP_TOL
    where the gradient is above float32 noise (elsewhere Adam's first step
    is lr * g / (|g| + eps), decided by the noise).  Plain SGD, whose update
    scales with the gradient, moves the parameters by lr times the
    reference's gradient."""
    inp, res = port
    c = inp["train_step"]
    v = jclip.VARIANTS[c["variant"]]
    jp = jax.tree.map(jnp.asarray, c["tree"])
    tx, st = jcon.init_train_state(jp, lr=c["lr"])
    _, _, jl = jcon.make_train_step(v, tx, dtype=jnp.float32)(jp, st, jnp.asarray(c["imgs"]), jnp.asarray(c["toks"]))
    jgrad = _np(jax.grad(jcon.clip_loss)(jax.tree.map(jnp.asarray, c["tree"]), jnp.asarray(c["imgs"]),
                                         jnp.asarray(c["toks"]), v, jnp.float32))
    g = bridge.flatten(jgrad)
    sgd = layout.endswith("sgd")
    single_losses, single, _ = res[0]["train_step"]["single_sgd" if sgd else "single"]
    single = bridge.flatten(single)
    assert abs(single_losses[0] - float(jl)) <= STEP_TOL
    for r in res:
        losses, params, grads = r["train_step"][layout]
        assert abs(losses[0] - float(jl)) <= STEP_TOL
        _close_trees(jgrad, grads, GRAD_TOL)
        got = bridge.flatten(params)
        if sgd:
            p0 = bridge.flatten(c["tree"])
            _close_trees(jgrad, {k: (p0[k] - a) / c["sgd_lr"] for k, a in got.items()}, GRAD_TOL)
            continue
        for k, a in single.items():
            signal = np.abs(g[k]) > 1e-6 * np.abs(g[k]).max()
            assert np.abs(a - got[k])[signal].max(initial=0.0) <= STEP_TOL, k
            assert np.abs(a - got[k]).max() <= 2e-3 + STEP_TOL, k
    _same_on_every_rank([{"p": r["train_step"][layout][1]} for r in res], "p")


def test_mesh_entry_points_need_cuda_unless_asked_for_the_cpu():
    """make_mesh and launch.spawn run on the card unless given "cpu": with no
    card they raise, as every entry point of the port does."""
    from holoagent_tpu_torch.parallel import make_mesh as tmake_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmake_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.spawn(ranks.run_cases, 2, args=("unused", []))
