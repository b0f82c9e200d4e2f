"""The port's serving slice against the JAX package's, at test-tiny in
float32 with bridged weights: ContinuousBatcher (every generated string,
token count and prompt length equal to the reference batcher's for the same
prompts and weights), GenerativeVLM (the same answers and stats),
apps.serving_bench on the CPU (the reference's keys) and the whole slice,
apps.query_bench --slow --vlm generative (the same objects and vlm_work per
query).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slow_query import SLOW_INSTRUCTIONS, _view_graph

from holoagent_tpu import config as jconfig
from holoagent_tpu.apps import query_bench as jquery_bench
from holoagent_tpu.apps import serving_bench as jserving_bench
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import vlm as jvlm
from holoagent_tpu.query import vlm_backend as jbackend
from holoagent_tpu.serving import ContinuousBatcher as JBatcher
from holoagent_tpu.serving import GenRequest as JRequest
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.apps import query_bench, serving_bench
from holoagent_tpu_torch.config import Config
from holoagent_tpu_torch.dataloader import SyntheticDataset
from holoagent_tpu_torch.memory import hmsg, nodes
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import vlm
from holoagent_tpu_torch.query import GenerativeVLM
from holoagent_tpu_torch.serving import ContinuousBatcher, GenRequest

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    """(JAX vlm params, JAX CLIP params, port VLM, port visual tower) per
    arch: test-tiny and test-tiny-llama over the test-tiny CLIP tower."""
    cparams = jclip.init_clip(jax.random.key(1), jclip.VARIANTS["test-tiny"])
    visual = bridge.clip_from_jax(jax.tree.map(np.asarray, cparams), tclip.VARIANTS["test-tiny"], device="cpu")
    out = {}
    for name, seed in (("test-tiny", 0), ("test-tiny-llama", 3)):
        params = jvlm.init_vlm(jax.random.key(seed), jvlm.VARIANTS[name])
        out[name] = (params, cparams,
                     bridge.vlm_from_jax(jax.tree.map(np.asarray, params), vlm.VARIANTS[name], device="cpu"), visual)
    return out


def _pair(weights, name="test-tiny", max_batch=2, **kw):
    params, cparams, m, visual = weights[name]
    return (JBatcher(params, cparams, jvlm.VARIANTS[name], max_batch=max_batch, dtype=jnp.float32, **kw),
            ContinuousBatcher(m, visual, max_batch=max_batch, **kw))


def _serve(b, request_cls, calls, submit_after=()):
    """Submit `calls` [(prompt, images, max_new_tokens)], step until done;
    requests in `submit_after` are submitted after the first step."""
    reqs = [b.submit(request_cls(p, im, n)) for p, im, n in calls]
    b.step()
    reqs += [b.submit(request_cls(p, im, n)) for p, im, n in submit_after]
    while not all(r._done.is_set() for r in reqs):
        b.step()
    return [(r.result(), r.generated, r.prompt_tokens) for r in reqs]


IMAGES = np.random.default_rng(0).uniform(size=(2, 48, 64, 3)).astype(np.float32)
CALLS = [("where is the chair", None, 10), ("go to the kitchen", None, 7), ("find the plant", None, 5),
         ("which image shows a chair?", IMAGES, 6)]


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-llama"])
def test_batcher_chunked_continuous(weights, name):
    """Four requests over two slots, a chunk of 4 tokens, one with two
    images: admission between chunks; the same strings as the reference."""
    jb, b = _pair(weights, name, chunk=4)
    want, got = _serve(jb, JRequest, CALLS), _serve(b, GenRequest, CALLS)
    assert got == want
    assert b.steps == jb.steps
    assert all(0 < n <= c[2] for (_, n, _), c in zip(got, CALLS))


def test_batcher_chunk_1_equals_chunk_4(weights):
    """chunk=1 (a token a step), pipeline_depth 1 (read every chunk) and the
    defaults give the reference's strings."""
    jb, _ = _pair(weights, chunk=4)
    want = _serve(jb, JRequest, CALLS[:3])
    for kw in (dict(chunk=1), dict(chunk=4, pipeline_depth=1), dict(chunk=4, pipeline_depth=3)):
        _, b = _pair(weights, **kw)
        assert _serve(b, GenRequest, CALLS[:3]) == want, kw
    _, b1 = _pair(weights, max_batch=1, chunk=1)
    assert b1.generate("where is the chair", max_new_tokens=10) == want[0][0]


def test_batcher_interleaved(weights):
    """A request admitted while another decodes shares its chunks."""
    jb, b = _pair(weights, chunk=2)
    first, later = [("first request", None, 6)], [("second one", None, 4)]
    assert _serve(b, GenRequest, first, later) == _serve(jb, JRequest, first, later)


def test_batcher_queue_longer_than_the_slots(weights):
    jb, b = _pair(weights, max_batch=1)
    calls = [(f"q{i}", None, 3) for i in range(3)]
    assert _serve(b, GenRequest, calls) == _serve(jb, JRequest, calls)


def test_batcher_refuses_a_mesh(weights):
    _, _, m, visual = weights["test-tiny"]
    with pytest.raises(NotImplementedError, match="item 9"):
        ContinuousBatcher(m, visual, mesh=object())


def test_generative_vlm_against_the_reference(weights):
    jb, b = _pair(weights)
    jv, tv = jbackend.GenerativeVLM(jb, max_new_tokens=4), GenerativeVLM(b, max_new_tokens=4)
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(size=(16, 16, 3)).astype(np.float32) for _ in range(3)]
    for backend, as_image in ((jv, jnp.asarray), (tv, torch.from_numpy)):
        backend.answers = [
            backend.detect_object(as_image(imgs[0]), "chair"),
            backend.choose_frame([as_image(im) for im in imgs], "a chair"),
            backend.detect_and_select_best([as_image(im) for im in imgs[:2]], "chair"),
            backend.rethink_wave([as_image(im) for im in imgs], "the chair", [as_image(imgs[1])], "chair"),
            backend.rethink_wave([], "the chair", [as_image(imgs[2])], "chair"),
        ]
    assert tv.answers == jv.answers
    assert tv.stats == jv.stats and tv.stats["waves"] == 5


def test_serving_bench_on_the_cpu(tmp_path):
    kw = dict(variant="test-tiny", batch=2, requests=2, new_tokens=4, chunk=4, chain_calls=2)
    want = jserving_bench.run(**kw)
    got = serving_bench.run(**kw, device="cpu", out_path=str(tmp_path / "s.json"))
    assert set(want) - set(got) == {"device"} - set(got)
    assert json.loads((tmp_path / "s.json").read_text()) == got
    assert got["device"] == "cpu" and set(got["timing"].values()) == {"cpu"}
    assert all(got[k] > 0 for k in ("decode_step_ms", "scan_decode_chunk_ms", "slow_chain_device_ms",
                                     "prefill_128_ms", "wall_tok_s"))
    assert got["batcher_steps"] > 0 and got["slow_chain_calls"] == 2


def test_query_bench_slow_generative_against_the_reference(weights, tmp_path, monkeypatch):
    """The whole slice: query_bench --slow --vlm generative over the same
    graph and frames in both packages, with the same test-tiny VLM (float32)
    behind each engine: the same objects and vlm_work per query, and the
    device-derived fields by the reference's formula from a rates file."""
    params, cparams, m, visual = weights["test-tiny"]
    ctparams = jclip.init_clip(jax.random.key(1), jclip.VARIANTS["test-tiny"])
    text = bridge.clip_text_from_jax(jax.tree.map(np.asarray, ctparams), tclip.VARIANTS["test-tiny"], device="cpu")
    real, jreal = tclip.text_features_multi_template, jclip.text_features_multi_template
    monkeypatch.setattr(tclip, "text_features_multi_template",
                        lambda t, tok, labels, **kw: real(t, tok, labels, dtype=torch.float32))
    monkeypatch.setattr(jclip, "text_features_multi_template",
                        lambda p, tok, labels, variant, **kw: jreal(p, tok, labels, variant, dtype=jnp.float32))
    monkeypatch.setattr(jquery_bench, "_make_vlm", lambda *a: jbackend.GenerativeVLM(
        JBatcher(params, cparams, jvlm.VARIANTS["test-tiny"], max_batch=8, dtype=jnp.float32), max_new_tokens=8))
    backend = GenerativeVLM(ContinuousBatcher(m, visual, max_batch=8), max_new_tokens=8)
    ds, jds = SyntheticDataset(num_frames=12, hw=(48, 64)), JSyntheticDataset(num_frames=12, hw=(48, 64))
    _view_graph(nodes, hmsg.HMSGraph).save(tmp_path / "graph")
    rates = tmp_path / "rates.json"
    rates.write_text(json.dumps({"prefill_128_ms": 2.5, "decode_step_ms": 0.75, "decode_chunk": 8}))
    got = query_bench.run(str(tmp_path / "graph"), SLOW_INSTRUCTIONS, Config(), use_slow=True, vlm_kind="generative",
                          dataset=ds, models=(visual, None, visual.variant, None, text), device="cpu", vlm=backend,
                          rates_path=str(rates), out_path=str(tmp_path / "p.json"))
    want = jquery_bench.run(str(tmp_path / "graph"), SLOW_INSTRUCTIONS, jconfig.Config(), use_slow=True,
                            vlm_kind="generative", dataset=jds, models=(ctparams, None, jclip.VARIANTS["test-tiny"], None),
                            out_path=str(tmp_path / "j.json"))
    assert [r["objects"] for r in got["results"]] == [r["objects"] for r in want["results"]]
    assert [r["vlm_work"] for r in got["results"]] == [r["vlm_work"] for r in want["results"]]
    assert sum(r["vlm_work"]["waves"] for r in got["results"]) > 0
    assert got == json.loads((tmp_path / "p.json").read_text())
    derived = jquery_bench._device_derived(got["results"], str(rates))
    assert got["p50_device_derived"] == derived["p50_device_derived"]
    assert got["p95_device_derived"] == derived["p95_device_derived"]
    assert got["device_derivation"] == derived["device_derivation"]
    assert query_bench._device_derived(got["results"], None) == {}
