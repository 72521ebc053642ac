"""Every arch the port runs, at smoke width, against the JAX package: the
port's mirror of ``tests/test_archs_smoke.py``.  Same converted weights,
float32, TD-VMM off, batch 2: a 12-token prefill, then 5 decode steps fed
the reference's greedy tokens (or, for the embedding-input archs, the same
seeded normal embeddings); greedy tokens equal and logits within
LOGIT_RTOL of max|logit| at every step.  Every arch of the repo is a
case, zamba2's hybrid segments included (tests/test_torch_hybrid.py holds
them further)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.models import model as tmodel

# Relative to max|logit| over the run.  Both sides run the same float32
# algebra and sum in other orders (attention, norms, the scan, the router):
# measured <= 9.8e-7 over the archs before zamba2 (zamba2 on its own
# inputs in tests/test_torch_hybrid.py: <= 1.7e-6).
LOGIT_RTOL = 1e-5
PREFILL, DECODE, BATCH = 12, 5, 2
PORTED = sorted(ARCHS)


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def test_the_port_knows_every_arch_of_the_reference():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", PORTED)
def test_arch_prefill_and_decode_match_reference(arch):
    jc, tc = jsmoke(jget(arch)), tsmoke(tget(arch))
    assert tc.dtype == "float32" and tc.input_mode == jc.input_mode
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    rng = np.random.default_rng(sum(map(ord, arch)))
    embeds = jc.input_mode == "embeddings"
    if embeds:
        steps = [rng.standard_normal((BATCH, n, jc.d_model)).astype(np.float32)
                 for n in [PREFILL] + [1] * DECODE]
    else:
        steps = [rng.integers(0, jc.vocab_size, (BATCH, PREFILL))]
    jcache = jmodel.init_caches(jc, BATCH, PREFILL + DECODE)
    tcache = tmodel.init_caches(tc, BATCH, PREFILL + DECODE, "cpu")
    lj, jcache = jmodel.prefill_step(jparams, {"inputs": jnp.asarray(steps[0])},
                                     jcache, jc)
    lt, tcache = tmodel.prefill_step(tparams,
                                     {"inputs": torch.from_numpy(steps[0])},
                                     tcache, tc)
    got, want = [lt.numpy()], [np.asarray(lj)]
    for i in range(DECODE):
        tok_j = np.argmax(want[-1][:, -1, :jc.vocab_size], -1)
        tok_t = np.argmax(got[-1][:, -1, :tc.vocab_size], -1)
        np.testing.assert_array_equal(tok_t, tok_j)
        step = steps[1 + i] if embeds else tok_j[:, None]
        lj, jcache = jmodel.decode_step(jparams, {"inputs": jnp.asarray(step)},
                                        jcache, jc)
        lt, tcache = tmodel.decode_step(tparams,
                                        {"inputs": torch.from_numpy(step)},
                                        tcache, tc)
        got.append(lt.numpy())
        want.append(np.asarray(lj))
    np.testing.assert_array_equal(
        np.argmax(got[-1][:, -1, :tc.vocab_size], -1),
        np.argmax(want[-1][:, -1, :jc.vocab_size], -1))
    assert not any(np.isnan(g).any() for g in got)
    assert max(_rel(g, w) for g, w in zip(got, want)) <= LOGIT_RTOL
