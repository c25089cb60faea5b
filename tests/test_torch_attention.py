"""The port's chunked (flash) attention against the JAX package's
``repro.models.attention.flash_attention`` on the CPU, at sequence lengths
beyond one kv chunk (q_chunk = kv_chunk = 8 at S = 32, the smoke config's
head shape): the online softmax over kv chunks, its running max and
correction factors, in the reference's order.

Tolerance, f32: 1e-5 absolute on outputs of magnitude ~1 (and on their
gradients): the two frameworks sum the score and PV dots in different
orders and use different exp implementations, each a few ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jflash
from repro_torch.models.attention import flash_attention

B, S, H, D = 2, 32, 8, 32  # gpt-1.3b smoke: 8 heads of 32
ATOL = 1e-5


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12), (False, 0)])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(8, 8), (16, 8), (8, 32)])
def test_flash_attention_matches_reference(causal, window, q_chunk, kv_chunk):
    q, k, v = _qkv(q_chunk + kv_chunk + window)
    pos = np.arange(S)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                             jnp.asarray(pos), causal, window, q_chunk, kv_chunk))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(pos),
                          torch.from_numpy(pos), causal, window, q_chunk, kv_chunk).numpy()
    assert np.abs(got - want).max() <= ATOL


def test_flash_attention_gradients_match_reference():
    q, k, v = _qkv(1)
    ct = np.random.default_rng(2).standard_normal((B, S, H, D)).astype(np.float32)
    pos = np.arange(S)

    def f(q, k, v):
        o = jflash(q, k, v, jnp.asarray(pos), jnp.asarray(pos), True, 0, 8, 8)
        return jnp.sum(o * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(pos), True, 0, 8, 8)
    (o * torch.from_numpy(ct)).sum().backward()
    for w, t in zip(want, (qt, kt, vt)):
        assert np.abs(t.grad.numpy() - np.asarray(w)).max() <= ATOL


def test_chunked_differs_from_one_softmax_only_by_rounding():
    """The kv-chunked online softmax and one softmax over all keys are the
    same function: they agree within rounding, not bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3))
    pos = torch.arange(S)
    one = flash_attention(q, k, v, pos, pos, True, 0, S, S)
    chunked = flash_attention(q, k, v, pos, pos, True, 0, 8, 8)
    assert (one - chunked).abs().max().item() <= ATOL


def test_unaligned_chunks_raise():
    q = torch.zeros((1, 12, 1, 4))
    with pytest.raises(ValueError, match="multiples of the chunks"):
        flash_attention(q, q, q, torch.arange(12), torch.arange(12), True, 0, 8, 8)
