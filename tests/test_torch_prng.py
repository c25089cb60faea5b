"""The port's threefry twin is byte-equal to ``jax.random`` (partitionable
threefry, the JAX default) over the serve key catalog."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qsdp import _stable_hash
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.transformer import Model as JModel
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.configs import gpt_1_3b
from repro.train.step import _h
from repro_torch.core import prng
from repro_torch.data import SyntheticLM


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


def test_partitionable_mode_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prngkey_fold_in_split(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _key(jk) == tk
    for d in (0, 1, 15, 0x5D, 0x3A57E9, 2**32 - 1):
        assert _key(jax.random.fold_in(jk, d)) == prng.fold_in(tk, d)
    for num in (1, 2, 5):
        assert [_key(k) for k in jax.random.split(jk, num)] == prng.split(tk, num)


def test_stable_hash_copies():
    names = ["embed", "final_norm", "layers/wq", "layers/w_down", "dec/xwq", "ü"]
    assert [prng.stable_hash(n) for n in names] == [_stable_hash(n) for n in names]
    assert [prng.stable_hash(n) for n in names] == [_h(n) for n in names]


def test_serve_key_catalog_uniforms():
    """The keys one decode step of the smoke model derives, and the
    per-bucket shift draws made from them: step fold -> layer fold ->
    per-tensor name fold -> uniform (nb, 1) in [-0.5, 0.5)."""
    cfg = gpt_1_3b.smoke()
    model = JModel(cfg, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
    jkey, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for step in (0, 1, 7):
        js, ts = jax.random.fold_in(jkey, step), prng.fold_in(tkey, step)
        for layer in range(cfg.n_layers):
            jl, tl = jax.random.fold_in(js, layer), prng.fold_in(ts, layer)
            for name, spec in model.specs.items():
                if not name.startswith("layers/"):
                    jt = jax.random.fold_in(js, _stable_hash(name))
                    tt = prng.fold_in(ts, prng.stable_hash(name))
                else:
                    jt = jax.random.fold_in(jl, _stable_hash(name))
                    tt = prng.fold_in(tl, prng.stable_hash(name))
                assert _key(jt) == tt, (step, layer, name)
                nb = -(-spec.n_logical_local(1) // 1024)
                ju = np.asarray(jax.random.uniform(jt, (nb, 1), minval=-0.5, maxval=0.5))
                tu = prng.uniform(tt, (nb, 1), "cpu", -0.5, 0.5).numpy()
                assert ju.tobytes() == tu.tobytes(), (step, layer, name)


def test_uniform_segments_equal_separate_draws():
    """The draws K1 makes per segment (one key per quantized tensor, bits at
    its own counters) equal the separate ``uniform`` draws of each tensor."""
    from repro_torch.kernels import ref
    keys = [prng.fold_in(prng.PRNGKey(9), i) for i in range(4)]
    sizes = [3, 1, 256, 17]
    for k, n in zip(keys, sizes):
        shift, _ = ref.draw_rand(k, n, 1024, "shift")
        assert torch.equal(shift, prng.uniform(k, (n, 1), "cpu", -0.5, 0.5))
        stoch, _ = ref.draw_rand(k, 1, n, "stochastic")
        assert torch.equal(stoch, prng.uniform(k, (1, n), "cpu"))


@pytest.mark.parametrize("width", [16, 32])
def test_bits(width):
    jk = jax.random.PRNGKey(5)
    dt = jnp.uint16 if width == 16 else jnp.uint32
    j = np.asarray(jax.random.bits(jk, (33, 7), dt)).astype(np.int64)
    t = prng.bits(prng.PRNGKey(5), (33, 7), "cpu", width).numpy()
    assert (j == t).all()


@pytest.mark.parametrize("lo,hi", [(0, 8), (0, 1024), (0, 50304), (-7, 100)])
def test_randint(lo, hi):
    j = np.asarray(jax.random.randint(jax.random.PRNGKey(11), (4, 9), lo, hi))
    t = prng.randint(prng.PRNGKey(11), (4, 9), lo, hi).numpy()
    assert (j == t).all()


def test_synthetic_lm_tokens():
    for vocab, seq, b, seed, step in ((1024, 16, 3, 0, 0), (50304, 128, 4, 0, 0),
                                      (1024, 8, 2, 5, 3)):
        jt, jl = JSyntheticLM(vocab, seq, b, seed=seed).sample(step)
        tt, tl = SyntheticLM(vocab, seq, b, seed=seed).sample(step)
        assert (np.asarray(jt) == tt.numpy()).all()
        assert (np.asarray(jl) == tl.numpy()).all()
