"""The port's generative VLM (holoagent_tpu_torch/models/vlm.py) against the
JAX package's, at test-tiny (gpt) and test-tiny-llama, in float32, with the
JAX weights carried over by bridge.vlm_from_jax and numpy-seeded inputs.

Tolerances: logits, KV cache and embeddings within 2e-4 (absolute and
relative) of the reference's dense path; the gpt prefill within 2e-3 of
the reference's Pallas flash route in interpret mode (tests/test_vlm.py's
limit for flash against dense); lengths, tokens and slot masks exact, with
every compared greedy token's top-2 logit gap over 1e-3, so no tie decides
a comparison by chance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import vlm as jvlm
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.bridge import flatten
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import vlm

torch.set_num_threads(1)

TOL = 2e-4
FLASH_TOL = 2e-3
GAP = 1e-3
ARCHS = {"gpt": ("test-tiny", 0), "llama": ("test-tiny-llama", 3)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def clip_towers():
    params = jclip.init_clip(jax.random.key(1), jclip.VARIANTS["test-tiny"])
    return params, bridge.clip_from_jax(jax.tree.map(np.asarray, params), tclip.VARIANTS["test-tiny"], device="cpu")


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    name, seed = ARCHS[request.param]
    jv = jvlm.VARIANTS[name]
    params = jvlm.init_vlm(jax.random.key(seed), jv)
    return jv, params, bridge.vlm_from_jax(jax.tree.map(np.asarray, params), vlm.VARIANTS[name], device="cpu")


def _port_cache(jcache, v):
    c = vlm.init_cache(v, jcache.k.shape[1], torch.float32, "cpu")
    c.k.copy_(torch.from_numpy(np.array(jcache.k)))
    c.v.copy_(torch.from_numpy(np.array(jcache.v)))
    c.length.copy_(torch.from_numpy(np.array(jcache.length)))
    return c


def _assert_gaps(logits, rows=None):
    top2 = torch.topk(torch.as_tensor(np.asarray(logits)), 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]) if rows is None else (top2[rows, 0] - top2[rows, 1])
    assert float(gap.min()) > GAP, gap


def _prompt(jv, b=3, t=32, seed=0):
    rng = np.random.default_rng(seed)
    emb = (0.5 * rng.normal(size=(b, t, jv.width))).astype(np.float32)
    return emb, np.minimum([t, 19, 4, 11][:b], t).astype(np.int32)


def test_variants_match_the_reference():
    assert vlm.VARIANTS.keys() == jvlm.VARIANTS.keys()
    for k, jv in jvlm.VARIANTS.items():
        v = vlm.VARIANTS[k]
        assert vars(v) == vars(jv) and (v.n_kv, v.hidden) == (jv.n_kv, jv.hidden)


def test_init_vlm_shapes_and_seed():
    """The reference's init_vlm tree, leaf for leaf (blocks unstacked); one
    seed, one model."""
    for name in ("test-tiny", "test-tiny-llama"):
        a = vlm.init_vlm(vlm.VARIANTS[name], seed=5, device="cpu")
        b = vlm.init_vlm(vlm.VARIANTS[name], seed=5, device="cpu")
        shapes = jax.eval_shape(lambda k: jvlm.init_vlm(k, jvlm.VARIANTS[name]), jax.random.key(0))
        want = flatten(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes))
        got = dict(a.named_parameters())
        n_block = sum(k.startswith("blocks.") for k in want)
        assert len(got) == len(want) - n_block + a.variant.layers * n_block
        for k, p in got.items():
            ref = want[f"blocks.{k.split('.', 2)[2]}"].shape[1:] if k.startswith("blocks.") else want[k].shape
            assert tuple(p.shape) == tuple(ref), k
        assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_prefill_against_the_reference(model):
    jv, params, m = model
    emb, vl = _prompt(jv)
    jc = jvlm.init_cache(jv, 3, jnp.float32)
    want_l, want_c = jvlm.prefill(params, jnp.asarray(emb), jnp.asarray(vl), jc, jv, dtype=jnp.float32)
    c = vlm.init_cache(m.variant, 3, torch.float32, "cpu")
    got_l, got_c = vlm.prefill(m, torch.from_numpy(emb), vl, c)
    assert got_c is c
    _close(got_l, want_l)
    _close(got_c.k, want_c.k)
    _close(got_c.v, want_c.v)
    assert got_c.length.tolist() == np.asarray(want_c.length).tolist()
    if jv.arch == "gpt":
        # the reference's Pallas flash route (interpret mode) and the port's plain route, by name
        fl, fc = jvlm.prefill(params, jnp.asarray(emb), jnp.asarray(vl), jc, jv, dtype=jnp.float32, impl="flash",
                              interpret=True)
        _close(got_l, fl, FLASH_TOL)
        _close(got_c.k, fc.k, FLASH_TOL)
        xl, _ = vlm.prefill(m, torch.from_numpy(emb), vl, vlm.init_cache(m.variant, 3, torch.float32, "cpu"),
                            impl="xla")
        _close(xl, want_l)


def test_decode_step_every_row(model):
    """All rows' logits, active and inactive (whose new key is attended and
    then dropped), and a row at max_seq whose write the reference drops."""
    jv, params, m = model
    rng = np.random.default_rng(1)
    b = 4
    shape = (jv.layers, b, jv.max_seq, jv.n_kv, jv.width // jv.heads)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    length = np.asarray([5, 9, 17, jv.max_seq], np.int32)
    jc = jvlm.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(length))
    tok = np.asarray([3, 11, 200, 42], np.int32)
    active = np.asarray([True, False, True, True])
    want_l, want_c = jvlm.decode_step(params, jnp.asarray(tok), jc, jnp.asarray(active), jv, dtype=jnp.float32)
    got_l, got_c = vlm.decode_step(m, torch.from_numpy(tok).long(), _port_cache(jc, m.variant),
                                   torch.from_numpy(active))
    _close(got_l, want_l)
    _close(got_c.k, want_c.k)
    _close(got_c.v, want_c.v)
    assert got_c.length.tolist() == np.asarray(want_c.length).tolist()
    # the inactive row's cache is its old cache, bit for bit
    assert np.array_equal(got_c.k[:, 1].numpy(), k[:, 1]) and np.array_equal(got_c.v[:, 1].numpy(), v[:, 1])


def _prefilled(jv, params, m, b=3):
    emb, vl = _prompt(jv, b=b, t=16, seed=6)
    vl = np.minimum(vl, 16)
    jl, jc = jvlm.prefill(params, jnp.asarray(emb), jnp.asarray(vl), jvlm.init_cache(jv, b, jnp.float32), jv,
                          dtype=jnp.float32)
    cur = np.asarray(jnp.argmax(jl, -1), np.int32)
    return jc, cur


def _stepwise_logits(m, jc, cur, active, steps):
    """The port's own per-step logits of a chunk (for the tie guard)."""
    c, tok, out = _port_cache(jc, m.variant), torch.from_numpy(cur).long(), []
    for _ in range(steps):
        logits, c = vlm.decode_step(m, tok, c, torch.from_numpy(active))
        out.append(logits)
        tok = logits.argmax(-1)
    return out


def test_decode_chunk_against_the_reference(model):
    jv, params, m = model
    jc, cur = _prefilled(jv, params, m)
    active = np.asarray([True, False, True])
    steps = 5
    for logits in _stepwise_logits(m, jc, cur, active, steps):
        _assert_gaps(logits)
    wt, wl, wc = jvlm.decode_chunk(params, jnp.asarray(cur), jc, jnp.asarray(active), jv, steps=steps,
                                   dtype=jnp.float32)
    gt, gl, gc = vlm.decode_chunk(m, torch.from_numpy(cur).long(), _port_cache(jc, m.variant),
                                  torch.from_numpy(active), steps=steps)
    assert gt.tolist() == np.asarray(wt).tolist() and gl.tolist() == np.asarray(wl).tolist()
    assert gc.length.tolist() == np.asarray(wc.length).tolist()
    _close(gc.k, wc.k)


def test_decode_chunk_tracked_against_the_reference(model):
    jv, params, m = model
    jc, cur = _prefilled(jv, params, m)
    active = np.asarray([True, True, False])
    remaining = np.asarray([6, 2, 4], np.int32)
    steps = 6
    # slot 1 freezes after its budget of 2; slot 2 never runs
    for i, logits in enumerate(_stepwise_logits(m, jc, cur, active, steps)):
        _assert_gaps(logits, rows=[0, 1] if i < 2 else [0])
    # an EOT id that one live slot emits mid-chunk, so its freeze is tracked
    eot = int(vlm.decode_chunk(m, torch.from_numpy(cur).long(), _port_cache(jc, m.variant),
                               torch.from_numpy(active), steps=3)[0][2, 0])
    want = jvlm.decode_chunk_tracked(params, jnp.asarray(cur), jc, jnp.asarray(active), jnp.asarray(remaining),
                                     jnp.int32(eot), jv, steps=steps, dtype=jnp.float32)
    got = vlm.decode_chunk_tracked(m, torch.from_numpy(cur).long(), _port_cache(jc, m.variant),
                                   torch.from_numpy(active), torch.from_numpy(remaining).long(), eot, steps=steps)
    for g, w, name in zip(got, want, ("toks", "act_hist", "last", "cache", "active", "remaining")):
        if name == "cache":
            assert g.length.tolist() == np.asarray(w.length).tolist()
            _close(g.k, w.k)
        else:
            assert g.tolist() == np.asarray(w).tolist(), name
    s = got[0][:, 0].tolist().index(eot)  # slot 0 froze on the EOT, slot 1 on its budget
    assert got[1][:, 0].tolist() == [True] * (s + 1) + [False] * (steps - s - 1)
    assert got[1][:, 1].tolist() == [True, True] + [False] * (steps - 2) and got[4].tolist() == [False] * 3


def test_admit_wave_keeps_the_other_rows(model):
    jv, params, m = model
    jc, cur = _prefilled(jv, params, m, b=4)
    emb, _ = _prompt(jv, b=4, t=16, seed=3)
    ns = np.asarray([7, 3, 16, 1], np.int32)
    admit = np.asarray([False, True, True, False])
    emb[~admit] = 0
    wcur, wc = jvlm.admit_wave(params, jnp.asarray(emb), jnp.asarray(ns), jnp.asarray(admit), jc, jnp.asarray(cur),
                               jv, dtype=jnp.float32)
    c = _port_cache(jc, m.variant)
    k0, v0, len0 = c.k.clone(), c.v.clone(), c.length.clone()
    gcur, gc = vlm.admit_wave(m, torch.from_numpy(emb), ns, admit, c, torch.from_numpy(cur).long())
    for i in np.nonzero(~admit)[0]:
        assert torch.equal(gc.k[:, i], k0[:, i]) and torch.equal(gc.v[:, i], v0[:, i])
        assert int(gc.length[i]) == int(len0[i]) and int(gcur[i]) == int(cur[i])
    logits, _ = vlm.prefill(m, torch.from_numpy(emb), np.maximum(ns, 1), vlm.init_cache(m.variant, 4, torch.float32,
                                                                                          "cpu"))
    _assert_gaps(logits, rows=np.nonzero(admit)[0])
    assert gcur.tolist() == np.asarray(wcur).tolist()
    assert gc.length.tolist() == np.asarray(wc.length).tolist()
    _close(gc.k, wc.k)
    _close(gc.v, wc.v)


def test_prompt_embeddings_against_the_reference(model, clip_towers):
    jv, params, m = model
    cparams, visual = clip_towers
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(3, 32, 32, 3)).astype(np.float32)
    pre = jclip.preprocess(jnp.asarray(images), 32)
    tpre = tclip.preprocess(torch.from_numpy(images), 32)
    _close(vlm.encode_images(m, visual, tpre), jvlm.encode_images(params, cparams, pre, jv, dtype=jnp.float32))
    ids = rng.integers(0, jv.vocab, 10).astype(np.int32)
    for t in (64, 16, 8):  # text cut by t, images cut by t
        pad = np.zeros(64, np.int32)
        pad[:10] = ids
        we, wn = jvlm.image_text_prompt_embeddings(params, cparams, jnp.asarray(pad), jnp.int32(10), pre, t, jv,
                                                   dtype=jnp.float32)
        ge, gn = vlm.image_text_prompt_embeddings(m, visual, torch.from_numpy(ids), 10, tpre, t)
        assert gn == int(wn)
        _close(ge, we)
    ids2 = rng.integers(0, jv.vocab, (3, 20)).astype(np.int32)
    ns = np.asarray([20, 7, 1], np.int32)
    _close(vlm.text_prompt_embeddings(m, torch.from_numpy(ids2), torch.from_numpy(ns)),
           jvlm.text_prompt_embeddings(params, jnp.asarray(ids2), jnp.asarray(ns), jv, dtype=jnp.float32))
    for images_in in (None, (pre, tpre)):
        we, wn = jvlm.build_prompt_embeddings(params, cparams, ids, None if images_in is None else images_in[0], jv,
                                              max_len=40, dtype=jnp.float32)
        ge, gn = vlm.build_prompt_embeddings(m, visual, ids, None if images_in is None else images_in[1], 40)
        assert gn == int(wn)
        _close(ge, we)


# ---------------------------------------------------------------------------
# convert_hf_llava on synthetic state dicts
# ---------------------------------------------------------------------------

JVL = jvlm.VARIANTS["test-tiny-llama"]


def _hf_llama_state_dict(prefix, tied, projector, seed=0):
    """A LlamaForCausalLM-shaped state dict of numpy arrays under `prefix`
    (plus the LLaVA projector and a vision-tower key that must be skipped)."""
    rng = np.random.default_rng(seed)
    w, dh = JVL.width, JVL.width // JVL.heads

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {"model.vision_tower.vision_model.post_layernorm.weight": r(w)} if projector else {}
    lm = prefix + ("model." if not prefix.endswith("language_model.") else "")
    for i in range(JVL.layers):
        p = f"{lm}layers.{i}."
        sd.update({p + "input_layernorm.weight": r(w), p + "self_attn.q_proj.weight": r(JVL.heads * dh, w),
                   p + "self_attn.k_proj.weight": r(JVL.n_kv * dh, w), p + "self_attn.v_proj.weight": r(JVL.n_kv * dh, w),
                   p + "self_attn.o_proj.weight": r(w, JVL.heads * dh), p + "post_attention_layernorm.weight": r(w),
                   p + "mlp.gate_proj.weight": r(JVL.hidden, w), p + "mlp.up_proj.weight": r(JVL.hidden, w),
                   p + "mlp.down_proj.weight": r(w, JVL.hidden)})
    sd[f"{lm}embed_tokens.weight"] = r(JVL.vocab, w)
    sd[f"{lm}norm.weight"] = r(w)
    if not tied:
        sd[("language_model." if prefix == "language_model." else "") + "lm_head.weight"] = r(JVL.vocab, w)
    if projector:
        sd["multi_modal_projector.linear_1.weight"] = r(w, 32)
        sd["multi_modal_projector.linear_1.bias"] = r(w)
        if projector == 2:
            sd["multi_modal_projector.linear_2.weight"] = r(w, w)
            sd["multi_modal_projector.linear_2.bias"] = r(w)
    return sd


@pytest.mark.parametrize("prefix,tied,projector", [
    ("", False, 0),  # a bare LlamaForCausalLM
    ("", True, 0),  # tied embeddings
    ("language_model.", False, 2),  # LLaVA, the older key layout
    ("model.language_model.", True, 1),  # LLaVA, the newer key layout, one projector layer
])
def test_convert_hf_llava_against_the_reference(prefix, tied, projector):
    sd = _hf_llama_state_dict(prefix, tied, projector)
    want = flatten(jax.tree.map(np.asarray, jvlm.convert_hf_llava(sd, JVL)))
    got = vlm.convert_hf_llava({k: torch.from_numpy(a) for k, a in sd.items()}, vlm.VARIANTS[JVL.name], device="cpu")
    got_flat = {k: p.detach().numpy() for k, p in got.named_parameters()}
    want_flat = {k: a for k, a in want.items() if not k.startswith("blocks.")}
    for k, a in want.items():
        if k.startswith("blocks."):
            for i in range(JVL.layers):
                want_flat[f"blocks.{i}.{k[7:]}"] = a[i]
    assert got_flat.keys() == want_flat.keys()
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    assert hasattr(got, "proj2_w") == (projector == 2)


def test_convert_hf_llama_matches_transformers():
    """Logits of a converted transformers Llama: prefill and cached decode
    (the reference's test_convert_hf_llama_matches_transformers)."""
    pytest.importorskip("transformers")
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=JVL.vocab, hidden_size=JVL.width, intermediate_size=JVL.mlp_hidden,
        num_hidden_layers=JVL.layers, num_attention_heads=JVL.heads, num_key_value_heads=JVL.kv_heads,
        max_position_embeddings=JVL.max_seq, rope_theta=JVL.rope_theta, rms_norm_eps=JVL.norm_eps,
        attention_bias=False, mlp_bias=False, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    hf = LlamaForCausalLM(cfg).eval()
    m = vlm.convert_hf_llava(hf.state_dict(), vlm.VARIANTS[JVL.name], device="cpu")
    tokens = np.random.default_rng(0).integers(0, JVL.vocab, (2, 12))
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.numpy()
    cache = vlm.init_cache(m.variant, 2, torch.float32, "cpu")
    logits, cache = vlm.prefill(m, m.tok_emb[torch.tensor(tokens)], [12, 12], cache)
    np.testing.assert_allclose(logits.numpy(), ref[:, -1], atol=3e-4, rtol=3e-4)
    toks, cur = tokens, np.argmax(ref[:, -1], -1)
    for _ in range(3):
        logits, cache = vlm.decode_step(m, torch.from_numpy(cur), cache, torch.ones(2, dtype=torch.bool))
        toks = np.concatenate([toks, cur[:, None]], 1)
        with torch.no_grad():
            ref = hf(torch.tensor(toks)).logits.numpy()[:, -1]
        np.testing.assert_allclose(logits.numpy(), ref, atol=5e-4, rtol=5e-4)
        cur = np.argmax(ref, -1)
