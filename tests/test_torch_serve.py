"""``launch/serve.serve_static`` on the embedding-input archs
(llava-next-mistral-7b, musicgen-large) at smoke width on the CPU: fed the
reference ``serve()``'s own draws (its parameters, its normal prompt and
its one decode input, all from one key), the port's greedy tokens equal the
reference's, and its logits agree within LOGIT_RTOL of max|logit|; the CLI
serves them with ``--static``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke as tsmoke
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

ROOT = Path(__file__).resolve().parents[1]
# Relative to max|logit|: float32 on both sides, other summation orders
# (the same bound as tests/test_torch_model.py).
LOGIT_RTOL = 1e-5
EMBED_ARCHS = ["llava-next-mistral-7b", "musicgen-large"]
BATCH, PROMPT, GEN, SEED = 2, 10, 6, 3


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


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_serve_static_embedding_arch_matches_reference_serve(arch):
    jc, tc = jsmoke(jget(arch)), tsmoke(tget(arch))
    assert jc.input_mode == tc.input_mode == "embeddings"
    ref = jserve.serve(jc, BATCH, PROMPT, GEN, seed=SEED)
    # the reference's draws: params, prompt and the decode input, one key
    key = jax.random.PRNGKey(SEED)
    jparams = jmodel.init_params(key, jc)
    prompt = np.array(jax.random.normal(key, (BATCH, PROMPT, jc.d_model),
                                          jnp.float32))
    step = np.array(jax.random.normal(key, (BATCH, 1, jc.d_model)))
    assert prompt.dtype == step.dtype == np.float32
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                        "cpu")
    out = tserve.serve_static(tc, BATCH, PROMPT, GEN, device="cpu",
                              params=tparams, prompts=torch.from_numpy(prompt),
                              decode_inputs=torch.from_numpy(step))
    assert out["nan_steps"] == 0 and tuple(out["tokens"].shape) == (BATCH, GEN)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(ref["tokens"]))
    # logits of the same run, step by step
    jcache = jmodel.init_caches(jc, BATCH, PROMPT + GEN)
    tcache = tmodel.init_caches(tc, BATCH, PROMPT + GEN, "cpu")
    lj, jcache = jmodel.prefill_step(jparams, {"inputs": jnp.asarray(prompt)},
                                     jcache, jc)
    lt, tcache = tmodel.prefill_step(tparams,
                                     {"inputs": torch.from_numpy(prompt)},
                                     tcache, tc)
    worst = _rel(lt.numpy(), lj)
    for _ in range(GEN - 1):
        lj, jcache = jmodel.decode_step(jparams, {"inputs": jnp.asarray(step)},
                                        jcache, jc)
        lt, tcache = tmodel.decode_step(tparams,
                                        {"inputs": torch.from_numpy(step)},
                                        tcache, tc)
        worst = max(worst, _rel(lt.numpy(), lj))
    assert worst <= LOGIT_RTOL


def test_serve_static_draws_embedding_inputs_from_the_seed():
    tc = tsmoke(tget("musicgen-large"))
    params = tmodel.init_params(0, tc, device="cpu")
    a = tserve.serve_static(tc, 2, 7, 4, seed=5, device="cpu", params=params)
    b = tserve.serve_static(tc, 2, 7, 4, seed=5, device="cpu", params=params)
    assert tuple(a["tokens"].shape) == (2, 4) and a["nan_steps"] == 0
    assert torch.equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="decode_inputs"):
        tserve.serve_static(tc, 2, 7, 4, device="cpu", params=params,
                            decode_inputs=torch.zeros(2, 2, tc.d_model))
    qc = tsmoke(tget("qwen1.5-0.5b"))
    with pytest.raises(ValueError, match="takes tokens"):
        tserve.serve_static(qc, 2, 7, 4, device="cpu",
                            decode_inputs=torch.zeros(2, 1, qc.d_model))


def test_serve_cli_static_embedding_arch():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "musicgen-large", "--smoke", "--static", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[serve] musicgen-large batch=2" in out.stdout
    assert "[serve] sample:" in out.stdout
