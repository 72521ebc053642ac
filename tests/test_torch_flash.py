"""Flash attention in the port (``models/attention._attend_flash``,
``_attend_flash_blocks``, ``_flash``) against the JAX package's, on the
same float32 inputs made from a numpy seed: past ``FLASH_THRESHOLD`` with
lengths that are not block multiples, a sliding window, grouped-query
heads and a query offset; against the dense ``_attend``; and
``apply_train`` / ``apply_prefill`` above the threshold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import attention as jattn
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.models import attention as tattn

# Port against the reference, relative to max|out|: the same float32
# association; the dot products over the head dim and the p.v sums run in
# other orders (measured <= 1.2e-7 for the attention alone, <= 2.3e-7
# for apply_train's output and its input gradient).
REF_RTOL = 1e-5
# Flash against the dense softmax: the JAX package's own bound
# (tests/test_models.py::test_flash_matches_dense_attention).
DENSE_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _cfgs(window=None):
    """smoke(yi-34b) with grouped-query heads: 8 query heads over 2 KV
    heads of 16."""
    kw = dict(n_heads=8, n_kv_heads=2, swa_window=window)
    return jsmoke(jget("yi-34b")).replace(**kw), \
        tsmoke(tget("yi-34b")).replace(**kw)


def _qkv(seed, b, sq, skv, cfg):
    rng = np.random.default_rng(seed)
    d = cfg.resolved_head_dim
    q = (rng.standard_normal((b, sq, cfg.n_heads, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, skv, cfg.n_kv_heads, d)) * 0.5
         ).astype(np.float32)
    v = rng.standard_normal((b, skv, cfg.n_kv_heads, d)).astype(np.float32)
    return q, k, v


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("fn", ["_attend_flash", "_attend_flash_blocks"])
@pytest.mark.parametrize("s,window", [(2049, None), (3000, None),
                                      (2049, 1000), (3000, 1000)])
def test_flash_matches_reference_and_dense(fn, s, window):
    jc, tc = _cfgs(window)
    q, k, v = _qkv(s, 1, s, s, tc)
    want = np.asarray(getattr(jattn, fn)(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jc))
    got = getattr(tattn, fn)(*map(torch.from_numpy, (q, k, v)), tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    assert _rel(got.numpy(), want) <= REF_RTOL
    mask = tattn._causal_mask(s, s, 0, window, "cpu")
    dense = tattn._attend(*map(torch.from_numpy, (q, k, v)), mask, tc)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=DENSE_TOL,
                               atol=DENSE_TOL)


def test_flash_query_offset_matches_reference():
    """Fewer queries than keys, the queries' positions offset to the end of
    the key sequence (the JAX package's ``q_offset``)."""
    jc, tc = _cfgs(1000)
    q, k, v = _qkv(11, 2, 700, 2100, tc)
    want = np.asarray(jattn._attend_flash(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jc, q_offset=1400))
    got = tattn._attend_flash(*map(torch.from_numpy, (q, k, v)), tc,
                              q_offset=1400)
    assert _rel(got.numpy(), want) <= REF_RTOL
    mask = tattn._causal_mask(700, 2100, 1400, 1000, "cpu")
    dense = tattn._attend(*map(torch.from_numpy, (q, k, v)), mask, tc)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=DENSE_TOL,
                               atol=DENSE_TOL)


def test_block_skip_refuses_cross_attention():
    _, tc = _cfgs()
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 8, 16, tc))
    with pytest.raises(ValueError, match="self-attention"):
        tattn._attend_flash_blocks(q, k, v, tc)


def _attn_params(jc, tc):
    jp = jattn.init(jax.random.PRNGKey(0), jc, jnp.float32)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


@pytest.mark.parametrize("block_skip", [False, True])
def test_apply_train_above_the_threshold(monkeypatch, block_skip):
    """2049 tokens route through flash on both sides: outputs within
    REF_RTOL of the reference's, and the gradient of a loss through the
    port's flash (plain autograd) finite, nonzero and within REF_RTOL of
    max|g| of the reference's."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_BLOCK_SKIP", block_skip)
    jc, tc = _cfgs()
    jp, tp = _attn_params(jc, tc)
    b, s = 1, tattn.FLASH_THRESHOLD + 1
    x = (np.random.default_rng(3).standard_normal((b, s, tc.d_model)) * 0.3
         ).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))

    def jloss(p, xx):
        y = jattn.apply_train(p, xx, jc, jnp.asarray(pos))
        return jnp.sum(y * y), y

    (_, yj), gj = jax.value_and_grad(jloss, argnums=1, has_aux=True)(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tattn.apply_train(tp, xt, tc, torch.from_numpy(pos.copy()))
    (gt,) = torch.autograd.grad(torch.sum(yt * yt), xt)
    assert _rel(yt.detach().numpy(), np.asarray(yj)) <= REF_RTOL
    g = gt.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert _rel(g, np.asarray(gj)) <= REF_RTOL


def test_apply_prefill_above_the_threshold_fills_the_ring(monkeypatch):
    """A sliding-window prompt longer than its ring, past a lowered flash
    threshold: flash output equal to the reference's, and the ring holds
    the last ``window`` keys rolled so that position p sits at p % size,
    as the reference's."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(mod, "FLASH_BLOCK_Q", 8)
        monkeypatch.setattr(mod, "FLASH_BLOCK_KV", 8)
    jc, tc = _cfgs(12)
    jp, tp = _attn_params(jc, tc)
    b, s = 2, 29
    x = (np.random.default_rng(4).standard_normal((b, s, tc.d_model)) * 0.3
         ).astype(np.float32)
    jcache = jattn.init_cache(jc, b, 40, jnp.float32)
    yj, jcache = jattn.apply_prefill(jp, jnp.asarray(x), jc, jcache)
    tcache = tattn.init_cache(tc, b, 40, torch.float32, "cpu")
    yt, tcache = tattn.apply_prefill(tp, torch.from_numpy(x), tc, tcache)
    assert tuple(tcache.k.shape) == (b, 12, tc.n_kv_heads,
                                     tc.resolved_head_dim)
    assert _rel(yt.numpy(), np.asarray(yj)) <= REF_RTOL
    for name in ("k", "v"):
        assert _rel(getattr(tcache, name).numpy(),
                    np.asarray(getattr(jcache, name))) <= REF_RTOL
    assert tcache.pos.tolist() == [s] * b
