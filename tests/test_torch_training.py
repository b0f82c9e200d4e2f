"""The training slice of the port against the JAX package on the CPU:
the contrastive losses and their gradients, one AdamW step against optax,
remat, the SAM loss, the VLM distillation step (gpt and llama), the crop
and room-frame collectors, the first steps of both fixture trainers from a
bridged JAX init (and that the port's own trainers learn by the reference
tests' thresholds), distill_vlm on the oracle's answers, the W8A8 text
tower, and the kernel wrappers' refusal of autograd off the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.dataloader.synthetic import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.dataloader.synthetic import SyntheticScene as JSyntheticScene
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.models import vlm as jvlm
from holoagent_tpu.training import contrastive as jcon
from holoagent_tpu.training import distill as jdistill
from holoagent_tpu.training import perception as jperc
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.dataloader.synthetic import SyntheticDataset, SyntheticScene
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.models import transformer as tfm
from holoagent_tpu_torch.models import vlm as tvlm
from holoagent_tpu_torch.ops import flash_attention as tfa
from holoagent_tpu_torch.ops import quant_matmul as tqm
from holoagent_tpu_torch.parallel import make_mesh
from holoagent_tpu_torch.query import OracleVLM, tag_image
from holoagent_tpu_torch.training import contrastive as tcon
from holoagent_tpu_torch.training import distill as tdistill
from holoagent_tpu_torch.training import perception as tperc

CV = "test-tiny"
GRAD_TOL = 1e-4  # of max|g| per leaf
STEP_TOL = 1e-5  # abs, parameters after one AdamW step


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(want, got, tol, relative=True):
    """Every leaf of `got` within tol: absolute, or relative to the leaf's
    max|want|.  A relative scale is floored at 1e-3 of the tree's largest
    |want|: the attention key biases' gradients are analytically zero (a
    key bias adds one constant to a query's scores), so both packages'
    values there are float32 noise."""
    fw, fg = bridge.flatten(want), bridge.flatten(got)
    assert set(fw) == set(fg), set(fw) ^ set(fg)
    worst = {}
    top = max(float(np.abs(a).max()) for a in fw.values())
    for k, a in fw.items():
        scale = max(float(np.abs(a).max()), 1e-3 * top, 1e-30) if relative else 1.0
        worst[k] = float(np.abs(np.asarray(a, np.float64) - fg[k]).max()) / scale
    bad = {k: e for k, e in worst.items() if e > tol}
    assert not bad, bad
    return max(worst.values())


@pytest.fixture(scope="module")
def clip_init():
    """The reference's test-tiny init (float32) as numpy, and the same
    towers in the port; a batch of 4 images (plain and masked) and
    tokens."""
    v = jclip.VARIANTS[CV]
    tree = _np(jclip.init_clip(jax.random.key(0), v, dtype=jnp.float32))
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    imgs_m = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 400, (4, 77)).astype(np.int32)
    toks[:, 12] = 49407  # <eot>
    toks[:, 13:] = 0
    return tree, imgs, imgs_m, toks


def _port_clip(tree):
    tv = tclip.VARIANTS[CV]
    return tcon.clip_params(bridge.clip_from_jax(tree, tv, device="cpu", impl="xla"),
                            bridge.clip_text_from_jax(tree, tv, device="cpu", impl="xla"),
                            bridge.logit_scale_from_jax(tree))


def _grads(p: tcon.CLIPParams):
    return bridge.clip_to_numpy(p.visual, p.text, p.logit_scale, leaf=lambda t: t.grad)


def _params(p: tcon.CLIPParams):
    return bridge.clip_to_numpy(p.visual, p.text, p.logit_scale)


@pytest.mark.parametrize("blend", [False, True], ids=["clip_loss", "clip_blend_loss"])
def test_clip_losses_value_and_grads(clip_init, blend):
    tree, imgs, imgs_m, toks = clip_init
    v = jclip.VARIANTS[CV]
    jp = jax.tree.map(jnp.asarray, tree)
    if blend:
        want, gw = jax.value_and_grad(jcon.clip_blend_loss)(
            jp, jnp.asarray(imgs), jnp.asarray(imgs_m), jnp.asarray(toks), v, 0.4418, jnp.float32)
    else:
        want, gw = jax.value_and_grad(jcon.clip_loss)(jp, jnp.asarray(imgs), jnp.asarray(toks), v, jnp.float32)
    p = _port_clip(tree)
    if blend:
        got = tcon.clip_blend_loss(p, torch.from_numpy(imgs), torch.from_numpy(imgs_m), torch.from_numpy(toks),
                                   dtype=torch.float32)
    else:
        got = tcon.clip_loss(p, torch.from_numpy(imgs), torch.from_numpy(toks), dtype=torch.float32)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    _close_trees(_np(gw), _grads(p), GRAD_TOL)


@pytest.mark.parametrize("blend", [False, True], ids=["make_train_step", "make_blend_train_step"])
def test_train_step_matches_optax(clip_init, blend):
    """One step at lr 1e-3 (a visible update).  The loss equals the
    reference step's.  The parameters after torch's AdamW equal optax.adamw's
    update from the same gradients (the port's, which the loss test holds to
    the reference's) within 1e-5 abs.  Against the reference step's own
    parameters they agree within 1e-5 abs wherever the gradient is above
    float32 noise (|g| > 1e-6 max|g| of its leaf): where it is not (the key
    bias's gradient is analytically zero), Adam's first step is
    lr * g / (|g| + eps), whose sign and size the noise decides, in either
    package (ROADMAP.md section 3)."""
    tree, imgs, imgs_m, toks = clip_init
    v = jclip.VARIANTS[CV]
    jp = jax.tree.map(jnp.asarray, tree)
    tx, st = jcon.init_train_state(jp, lr=1e-3)
    p = _port_clip(tree)
    ttx = tcon.init_train_state(p, lr=1e-3)
    timgs, timgs_m, ttoks = torch.from_numpy(imgs), torch.from_numpy(imgs_m), torch.from_numpy(toks)
    if blend:
        loss_fn = lambda q: jcon.clip_blend_loss(q, jnp.asarray(imgs), jnp.asarray(imgs_m),  # noqa: E731
                                                 jnp.asarray(toks), v, 0.4418, jnp.float32)
        jnew, _, jl = jcon.make_blend_train_step(v, tx, dtype=jnp.float32)(
            jp, st, jnp.asarray(imgs), jnp.asarray(imgs_m), jnp.asarray(toks))
        tl = tcon.make_blend_train_step(tclip.VARIANTS[CV], ttx, dtype=torch.float32)(p, timgs, timgs_m, ttoks)
    else:
        loss_fn = lambda q: jcon.clip_loss(q, jnp.asarray(imgs), jnp.asarray(toks), v, jnp.float32)  # noqa: E731
        jnew, _, jl = jcon.make_train_step(v, tx, dtype=jnp.float32)(jp, st, jnp.asarray(imgs), jnp.asarray(toks))
        tl = tcon.make_train_step(tclip.VARIANTS[CV], ttx, dtype=torch.float32)(p, timgs, ttoks)
    assert abs(tl.item() - float(jl)) <= STEP_TOL
    # AdamW against optax.adamw on the same gradients
    jp0 = jax.tree.map(jnp.asarray, tree)
    tgrads = jax.tree.map(jnp.asarray, _grads(p))
    updates, _ = tx.update(tgrads, tx.init(jp0), jp0)
    import optax

    _close_trees(_np(optax.apply_updates(jp0, updates)), _params(p), STEP_TOL, relative=False)
    # against the reference step, where the gradient is above noise
    g = bridge.flatten(_np(jax.grad(loss_fn)(jp0)))
    want, got = bridge.flatten(_np(jnew)), bridge.flatten(_params(p))
    for k, a in want.items():
        signal = np.abs(g[k]) > 1e-6 * np.abs(g[k]).max()
        assert np.abs(a - got[k])[signal].max(initial=0.0) <= STEP_TOL, k
        assert np.abs(a - got[k]).max() <= 2e-3 + STEP_TOL, k  # lr * (1 + wd * |p|) bounds the rest
    moved = np.abs(got["visual.blocks.wqkv"] - tree["visual"]["blocks"]["wqkv"]).max()
    assert moved > 1e-4  # the step did move the weights
    # the step on a one-rank (1, 1) mesh in this process (DP and TP of
    # width 1, the collectives one-rank calls) is the single-device step
    pm, ps = _port_clip(tree), _port_clip(tree)
    ml = tcon.make_train_step(tclip.VARIANTS[CV], tcon.init_train_state(pm, lr=1e-3), mesh=make_mesh(device="cpu"),
                              dtype=torch.float32)(pm, timgs, ttoks)
    sl = tcon.make_train_step(tclip.VARIANTS[CV], tcon.init_train_state(ps, lr=1e-3), dtype=torch.float32)(
        ps, timgs, ttoks)
    assert ml.item() == sl.item()
    _close_trees(_params(ps), _params(pm), 0.0, relative=False)


def test_remat_gives_equal_gradients(clip_init):
    tree, imgs, _, toks = clip_init
    grads = []
    for remat in (False, True):
        p = _port_clip(tree)
        f = tclip.forward_image(p.visual, torch.from_numpy(imgs), impl="xla", dtype=torch.float32, remat=remat)
        (f * torch.arange(f.shape[-1])).sum().backward()
        grads.append(bridge.flatten(bridge.clip_to_numpy(p.visual, leaf=lambda t: t.grad)))
    for k in grads[0]:
        assert np.array_equal(grads[0][k], grads[1][k]), k


def test_sam_loss_value_and_grads():
    v = jsam.VARIANTS["fixture-tiny"]
    tree = _np(jsam.init_sam(jax.random.key(1), v, dtype=jnp.float32))
    rng = np.random.default_rng(2)
    img = rng.normal(size=(128, 128, 3)).astype(np.float32)
    pts = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    gt = (rng.uniform(size=(8, 64, 64)) > 0.6).astype(np.float32)
    loss_and_grad = jax.jit(jax.value_and_grad(jperc._sam_loss), static_argnums=4)
    want, gw = loss_and_grad(jax.tree.map(jnp.asarray, tree), jnp.asarray(img), jnp.asarray(pts), jnp.asarray(gt), v)
    sam = tfm.trainable(bridge.sam_from_jax(tree, tsam.VARIANTS["fixture-tiny"], device="cpu"))
    got = tperc._sam_loss(sam, torch.from_numpy(img), torch.from_numpy(pts), torch.from_numpy(gt))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))
    _close_trees(_np(gw), bridge.sam_to_numpy(sam, leaf=lambda t: t.grad if t.grad is not None else torch.zeros_like(t)),
                 GRAD_TOL)


def test_adamw_matches_optax_over_steps_and_zero_gradients():
    """The trainers' optimizer (``contrastive.adamw``) against
    ``optax.adamw`` at the SAM recipe's lr and decay, over 8 steps from the
    same gradients: the bias corrections step by step (the schedule is
    constant in both) and decay on every leaf, also where the gradient is
    an exact zero tensor, as the SAM loss gives ``point_neg`` and the
    hypernetworks of tokens no prompt picked (the port's backward leaves no
    SAM gradient None: tests/test_torch_training.py's SAM loss test)."""
    import optax

    rng = np.random.default_rng(5)
    shapes = {"a": (16, 8), "b": (32,), "zero": (4, 4)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for step in range(8):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        g["zero"][:] = 0
        if 2 <= step <= 4:  # a leaf whose gradient falls to zero for three steps
            g["b"][:] = 0
        grads.append(g)
    tx = optax.adamw(2e-3, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, init)
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(a.copy())) for k, a in init.items()}
    opt = tcon.adamw(params.values(), 2e-3, weight_decay=0.01)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in params.items():  # a few float32 ulps: torch scales p by 1 - lr·wd, optax subtracts lr·wd·p
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=4e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-llama"], ids=["gpt", "llama"])
def test_distill_step_matches_reference(name):
    v = jvlm.VARIANTS[name]
    tree = _np(jvlm.init_vlm(jax.random.key(3), v))
    rng = np.random.default_rng(4)
    embs = rng.normal(size=(3, 16, v.width)).astype(np.float32)
    lens = np.array([16, 9, 5], np.int32)
    tgts = rng.integers(0, min(v.vocab, 200), 3).astype(np.int32)
    jp, jl = jdistill.distill_step(jax.tree.map(jnp.asarray, tree), jnp.asarray(embs), jnp.asarray(lens),
                                   jnp.asarray(tgts), v, lr=5e-2)
    vlm = bridge.vlm_from_jax(tree, tvlm.VARIANTS[name], device="cpu")
    tl = tdistill.distill_step(vlm, torch.from_numpy(embs), torch.from_numpy(lens).long(),
                               torch.from_numpy(tgts).long(), lr=5e-2)
    assert abs(tl.item() - float(jl)) <= 1e-4 * abs(float(jl))
    _close_trees(_np(jp), bridge.vlm_to_numpy(vlm), 1e-4, relative=False)
    assert all(p.grad is None for p in vlm.parameters())


@pytest.fixture(scope="module")
def walks():
    """tests/test_perception_training.py's 6 frames at 120x160, in both
    packages."""
    kw = dict(num_frames=6, hw=(120, 160), seed=100, gaze_heights=(0.8, 2.2))
    return ([JSyntheticDataset(scene=JSyntheticScene.two_room(), **kw)],
            [SyntheticDataset(scene=SyntheticScene.two_room(), **kw)])


def test_collect_crops_and_room_frames(walks):
    jds, tds = walks
    labels = jds[0].scene.labels() + ["background"]
    want = jperc.collect_crops(jds, labels, 32, margin=16, masked=True, structure=True)
    got = tperc.collect_crops(tds, labels, 32, margin=16, masked=True, structure=True)
    assert np.array_equal(want[2], got[2]) and len(got[2]) > 10
    for a, b in zip(want[:2], got[:2]):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5
    rects = [[(0.0, 0.0, 4.0, 6.0, "bedroom"), (4.0, 0.0, 8.0, 6.0, "kitchen")]]
    jf, jc = jperc.collect_room_frames(jds, rects, 32, jitter=2, seed=0)
    tf, tc = tperc.collect_room_frames(tds, rects, 32, jitter=2, seed=0)
    assert jc == tc and len(tc) > 0
    assert jf.shape == tf.shape and np.abs(jf - tf).max() <= 1e-5


@pytest.mark.parametrize("tower", ["clip", "sam"])
def test_fixture_trainers_first_steps_match_reference(walks, tower):
    """5 steps from the reference's seed-0 init, bridged: the same batches,
    the losses within 1e-4 of the reference's.  SAM's fifth loss is held
    within 1e-3: its gradients agree with the reference's to about 1e-8
    absolute, but Adam's first steps move an element by lr * g / (|g| +
    1e-8), so the few elements whose |g| is near 1e-8 (patch_w has some)
    move by a share of lr that those last bits decide; by step 5 that shows
    in the loss (3.2e-4 relative in the run this was written against; see
    ROADMAP.md section 3)."""
    jds, tds = walks
    if tower == "clip":
        labels = jds[0].scene.labels()
        _, want = jperc.train_tiny_clip(jds, labels, steps=5)
        tree = _np(jclip.init_clip(jax.random.key(0), jclip.VARIANTS[CV], dtype=jnp.float32))
        _, got = tperc.train_tiny_clip(tds, labels, steps=5, params=_port_clip(tree), device="cpu")
    else:
        _, want = jperc.train_tiny_sam(jds, steps=5, variant_name="fixture-tiny", lr=2e-3)
        tree = _np(jsam.init_sam(jax.random.key(0), jsam.VARIANTS["fixture-tiny"], dtype=jnp.float32))
        sam = bridge.sam_from_jax(tree, tsam.VARIANTS["fixture-tiny"], device="cpu")
        _, got = tperc.train_tiny_sam(tds, steps=5, variant_name="fixture-tiny", lr=2e-3, params=sam, device="cpu")
    assert len(got) == 5
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-4 if tower == "clip" else 1e-3, atol=0)


@pytest.mark.parametrize("tower", ["clip", "sam"])
def test_fixture_trainers_learn(walks, tower):
    """From the reference's seed-0 init, bridged, at
    tests/test_perception_training.py's steps and thresholds (the reference
    test's own configuration)."""
    _, tds = walks
    if tower == "clip":
        labels = tds[0].scene.labels()
        tree = _np(jclip.init_clip(jax.random.key(0), jclip.VARIANTS[CV], dtype=jnp.float32))
        params, losses = tperc.train_tiny_clip(tds, labels, steps=150, params=_port_clip(tree), device="cpu")
        assert np.mean(losses[-5:]) < 0.5 * losses[0]
        cv = tclip.VARIANTS[CV]
        crops, crops_m, ids = tperc.collect_crops(tds, labels, cv.image_size, margin=16, masked=True)
        from holoagent_tpu_torch.models.tokenizer import SimpleTokenizer

        tf = tclip.text_features_multi_template(params.text, SimpleTokenizer(), labels, dtype=torch.float32)
        mean, std = np.asarray(tclip.IMAGE_MEAN, np.float32), np.asarray(tclip.IMAGE_STD, np.float32)
        fp = tclip.encode_image(params.visual, torch.from_numpy((crops - mean) / std), impl="xla")
        fm = tclip.encode_image(params.visual, torch.from_numpy((crops_m - mean) / std), impl="xla")
        f = 0.4418 * fm + (1 - 0.4418) * fp
        f = f / f.norm(dim=-1, keepdim=True)
        top1 = ((f @ tf.T).argmax(-1).numpy() == ids).mean()
        assert top1 > 0.5, top1
    else:
        tree = _np(jsam.init_sam(jax.random.key(0), jsam.VARIANTS["fixture-tiny"], dtype=jnp.float32))
        sam = bridge.sam_from_jax(tree, tsam.VARIANTS["fixture-tiny"], device="cpu")
        sam, losses = tperc.train_tiny_sam(tds, steps=120, variant_name="fixture-tiny", lr=2e-3, params=sam,
                                           device="cpu")
        assert np.mean(losses[-10:]) < 0.6 * np.mean(losses[:5])
        g = tsam.generate_masks(sam, torch.from_numpy(tds[0][0].rgb), points_per_side=8, pred_iou_thresh=0.3,
                                stability_thresh=0.4, min_area=40.0, max_masks=16, impl="xla")
        assert int(g["num"]) >= 1


YES, NO = 3, 4


def _tokenize(prompt):
    return [1] + [2 + (sum(map(ord, wd)) % 200) for wd in prompt.split()][:12]


def test_distill_vlm_learns_oracle_answers():
    """tests/test_distill.py in the port: the tiny llama VLM learns the
    oracle's yes/no answers."""
    v = tvlm.VARIANTS["test-tiny-llama"]
    vlm = tvlm.init_vlm(v, seed=0, device="cpu")
    visual = tclip.init_clip_visual(tclip.VARIANTS[CV], seed=1, device="cpu", impl="xla")
    frames = {0: np.full((32, 32, 3), 0.2, np.float32), 2: np.full((32, 32, 3), 0.8, np.float32)}
    provider = lambda i: tag_image(frames[i], i)  # noqa: E731
    pairs = OracleVLM({0: {"mug"}, 2: {"towel"}}).distill_pairs([0, 2], ["mug", "towel"])
    assert len(pairs) == 4
    vlm, losses = tdistill.distill_vlm(vlm, visual, pairs, provider, _tokenize,
                                       answer_id=lambda a: YES if a == "yes" else NO, steps=120, lr=5e-2)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    correct = 0
    for prompt, img_ids, answer in pairs:
        imgs = torch.from_numpy(np.stack([provider(i) for i in img_ids]))
        e, n = tvlm.build_prompt_embeddings(vlm, visual, np.asarray(_tokenize(prompt), np.int32),
                                            tclip.preprocess(imgs, size=32), max_len=64)
        logits, _ = tvlm.prefill(vlm, e[None], torch.tensor([n]), tvlm.init_cache(v, 1, torch.float32, "cpu"),
                                 impl="xla")
        correct += int(logits[0, [YES, NO]].argmax()) == (0 if answer == "yes" else 1)
    assert correct == len(pairs)


def test_text_q8_tower_matches_reference():
    """quantize_clip on the text tower against quantize_clip(towers=
    ("visual", "text")): int8 weights and scales bit-equal, features within
    1e-3; the tree goes back through clip_text_from_jax."""
    v = jclip.VARIANTS[CV]
    params = jclip.init_clip(jax.random.key(0), v, dtype=jnp.float32)
    q = _np(jclip.quantize_clip(params, towers=("visual", "text")))
    text = bridge.clip_text_from_jax(_np(params), tclip.VARIANTS[CV], device="cpu")
    tq = tclip.quantize_clip(text)
    assert tq.quant and not hasattr(tq, "blocks")
    got = bridge.clip_to_numpy(text=tq)["text"]["blocks_q8"]
    for name, want in q["text"]["blocks_q8"].items():
        assert got[name].dtype == want.dtype and np.array_equal(got[name], want), name
    toks = np.random.default_rng(5).integers(1, 100, (3, v.ctx)).astype(np.int32)
    want = np.asarray(jclip.encode_text(jax.tree.map(jnp.asarray, q), jnp.asarray(toks), v, dtype=jnp.float32))
    for tower in (tq, bridge.clip_text_from_jax(q, tclip.VARIANTS[CV], device="cpu")):
        f = tclip.encode_text(tower, torch.from_numpy(toks), impl="xla", dtype=torch.float32).numpy()
        assert np.abs(f - want).max() <= 1e-3


def _meta(*shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_attention_2d", "quant_matmul",
                                     "batched_quant_matmul"])
def test_kernel_wrappers_refuse_autograd(wrapper):
    """Off the CPU (meta tensors reach the wrappers' CUDA branch without a
    card) an input that requires grad raises under grad mode, naming
    impl="xla"; under no_grad the wrapper goes on to its device checks.
    On the CPU the plain versions keep their autograd."""
    g = 14
    calls = {
        "flash_attention": lambda grad: tfa.flash_attention(*(_meta(1, 2, 77, 64, grad=grad) for _ in range(3)),
                                                            causal=True),
        "flash_attention_2d": lambda grad: tfa.flash_attention_2d(
            *(_meta(2, g * g, 64, grad=grad) for _ in range(3)), _meta(2, g * g, g, dtype=torch.float32, grad=grad),
            _meta(2, g * g, g, dtype=torch.float32, grad=grad), (g, g)),
        "quant_matmul": lambda grad: tqm.quant_matmul(
            _meta(77, 64, grad=grad), torch.empty(32, 64, dtype=torch.int8, device="meta"),
            torch.empty(32, device="meta"), _meta(32, dtype=torch.float32, grad=grad)),
        "batched_quant_matmul": lambda grad: tqm.batched_quant_matmul(
            _meta(2, 77, 64, grad=grad), torch.empty(32, 64, dtype=torch.int8, device="meta"),
            torch.empty(32, device="meta"), _meta(32, dtype=torch.float32, grad=grad)),
    }
    with pytest.raises(RuntimeError, match='impl="xla"'):
        calls[wrapper](True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        calls[wrapper](True)
    with pytest.raises(ValueError, match="CUDA device"):
        calls[wrapper](False)
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    x = torch.randn(4, 32, requires_grad=True)
    w_q, w_s = tfm.quantize_weight_int8(torch.randn(32, 16))
    b = torch.zeros(16, requires_grad=True)
    tqm.quant_matmul(x, w_q.t().contiguous(), w_s, b, out_dtype=torch.float32).sum().backward()
    assert q.grad is not None and b.grad is not None
