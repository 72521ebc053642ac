"""Code stages (encode_input / program_weights) of the port are bitwise the
JAX package's: same codes, same scales, for every width and tie case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro_torch.core import quant as tquant


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    # tests/test_tdcore.py turns on jax x64 at import; the port is float32
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


def _ties(rows: int, width: int, bits: int) -> np.ndarray:
    """Rows whose normalized values hit exact .5 code ties (max |x| = 1)."""
    levels = (1 << bits) - 1
    j = np.arange(width, dtype=np.float32)
    x = ((j % levels) + 0.5) / np.float32(levels)
    x = np.where(j % 2 == 0, x, -x).astype(np.float32)
    x[..., 0] = 1.0
    return np.broadcast_to(x, (rows, width)).copy()


def _inputs(width: int, bits: int) -> list[np.ndarray]:
    rng = np.random.default_rng(width)
    x = rng.standard_normal((5, width)).astype(np.float32) * 3.0
    x[1] = 0.0                                     # zero row: 1e-6 floor
    x[2, : width // 2] = 1e-8                      # below the floor
    return [x, _ties(3, width, bits),
            rng.standard_normal((2, 3, width)).astype(np.float32)]


# one compiled program per shape (eager JAX compiles every primitive)
_encode_j = jax.jit(jquant.encode_input, static_argnums=(1,))
_program_j = jax.jit(jquant.program_weights, static_argnums=(1, 2))


def _eq(a_t: torch.Tensor, a_j) -> None:
    a_j = np.asarray(a_j)
    assert tuple(a_t.shape) == a_j.shape
    np.testing.assert_array_equal(a_t.numpy(), a_j)


@pytest.mark.parametrize("bits", [4, 6, 7])
@pytest.mark.parametrize("width", [1, 3, 16, 63, 127, 130])
def test_encode_input_bitwise(width, bits):
    for x in _inputs(width, bits):
        qt = tquant.encode_input(torch.from_numpy(x), bits)
        qj = _encode_j(jnp.asarray(x), bits)
        assert qt.codes.dtype == torch.int8
        _eq(qt.codes, qj.codes)
        _eq(qt.scale, qj.scale)
        assert qt.levels == qj.levels


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("width", [1, 5, 64, 130])
def test_program_weights_bitwise(width, per_channel):
    rng = np.random.default_rng(width)
    w = rng.standard_normal((37, width)).astype(np.float32) * 0.05
    w[:, 0] = 0.0                                  # zero column
    for ww in (w, _ties(37, width, 6).T.copy(),
               rng.standard_normal((3, 17, width)).astype(np.float32)):
        qt = tquant.program_weights(torch.from_numpy(ww), 6, per_channel)
        qj = _program_j(jnp.asarray(ww), 6, per_channel)
        _eq(qt.codes, qj.codes)
        _eq(qt.scale, qj.scale)


def test_bf16_input_and_empty_batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 33)).astype(np.float32)
    xb_t = torch.from_numpy(x).to(torch.bfloat16)
    xb_j = jnp.asarray(x).astype(jnp.bfloat16)
    qt, qj = tquant.encode_input(xb_t, 6), jquant.encode_input(xb_j, 6)
    _eq(qt.codes, qj.codes)
    _eq(qt.scale, qj.scale)
    empty = np.zeros((0, 9), np.float32)
    qt = tquant.encode_input(torch.from_numpy(empty), 6)
    qj = jquant.encode_input(jnp.asarray(empty), 6)
    _eq(qt.codes, qj.codes)
    _eq(qt.scale, qj.scale)


def test_wide_codes_raise_until_ported():
    with pytest.raises(NotImplementedError, match="float32 storage"):
        tquant.encode_input(torch.ones(2, 3), 8)
    assert tquant.storage_dtype(7) == torch.int8
    assert tquant.storage_dtype(8) == torch.float32
