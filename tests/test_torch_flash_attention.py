"""Port parity: the plain versions of kernels K1/K2 against the JAX Pallas
kernels run in interpret mode, at the shapes of test_flash_attention.py.
Tolerance 2e-3 in float32 (the kernels' own test tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.ops import flash_attention as jfa
from holoagent_tpu_torch.ops import _cuda_build as cuda_build
from holoagent_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _qkv(rng, shape):
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [256, 384, 200])
def test_flash_attention_ref_matches_pallas(rng, causal, t):
    q, k, v = _qkv(rng, (2, 3, t, 64))
    ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, block_q=128, block_k=128, interpret=True,
    )
    out = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def _relpos_inputs(rng, g, bh=3, d=32):
    n = g * g
    q, k, v = _qkv(rng, (bh, n, d))
    rel_h = rng.normal(0, 0.5, (2 * g - 1, d)).astype(np.float32)
    rel_w = rng.normal(0, 0.5, (2 * g - 1, d)).astype(np.float32)
    idx = np.arange(g)
    rel = idx[:, None] - idx[None, :] + g - 1
    qg = q.reshape(bh, g, g, d)
    bias_h = np.einsum("byxd,ykd->byxk", qg, rel_h[rel]).reshape(bh, n, g)
    bias_w = np.einsum("byxd,xkd->byxk", qg, rel_w[rel]).reshape(bh, n, g)
    return q, k, v, bias_h.astype(np.float32), bias_w.astype(np.float32)


@pytest.mark.parametrize("g", [16, 32])
def test_flash_attention_2d_ref_matches_pallas(rng, g):
    args = _relpos_inputs(rng, g)
    n = g * g
    ref = jfa.flash_attention_2d(
        *(jnp.asarray(a) for a in args), grid_hw=(g, g),
        block_q=128 if n % 128 == 0 else 64, interpret=True,
    )
    out = tfa.flash_attention_2d_ref(*(torch.from_numpy(a) for a in args), grid_hw=(g, g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    """On CPU tensors the wrappers return the plain version's result exactly
    and leave the launch counters unchanged (they count kernel launches)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (1, 2, 200, 64)))
    args2d = [torch.from_numpy(a) for a in _relpos_inputs(rng, 14)]
    n1, n2 = tfa.flash_attention.launches, tfa.flash_attention_2d.launches
    out = tfa.flash_attention(q, k, v, causal=True)
    out2d = tfa.flash_attention_2d(*args2d, grid_hw=(14, 14))
    assert torch.equal(out, tfa.flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(out2d, tfa.flash_attention_2d_ref(*args2d, grid_hw=(14, 14)))
    assert (tfa.flash_attention.launches, tfa.flash_attention_2d.launches) == (n1, n2)


def test_wrappers_check_shapes(rng):
    q, k, v, bh, bw = (torch.from_numpy(a) for a in _relpos_inputs(rng, 14))
    with pytest.raises(ValueError):
        tfa.flash_attention_2d(q, k, v, bh, bw, grid_hw=(14, 15))
    with pytest.raises(ValueError):
        tfa.flash_attention(q[None], k[None, :, :10], v[None])


def test_build_key_tracks_the_source():
    """The build output is keyed by the source, for sm_90a."""
    path = tfa.LIB.path()
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert tfa.LIB.source.exists() and "mma.sync" in tfa.LIB.source.read_text()
