"""Code stages (encode_input / program_weights) of the port are bitwise the
JAX package's: same codes, same scales, for every width and tie case, in
int8 and (p = 8) float32 storage; int4 packing and the value-domain
readout likewise."""
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
    """p = 8 codes (once refused) take float32 storage, bitwise."""
    qt = tquant.encode_input(torch.ones(2, 3), 8)
    qj = _encode_j(jnp.ones((2, 3)), 8)
    assert qt.codes.dtype == torch.float32
    _eq(qt.codes, qj.codes)
    _eq(qt.scale, qj.scale)
    assert tquant.storage_dtype(7) == torch.int8
    assert tquant.storage_dtype(8) == torch.float32


@pytest.mark.parametrize("width", [1, 3, 63, 130])
def test_encode_input_p8_float32_codes_bitwise(width):
    for x in _inputs(width, 8):
        qt = tquant.encode_input(torch.from_numpy(x), 8)
        qj = _encode_j(jnp.asarray(x), 8)
        assert qt.codes.dtype == torch.float32
        _eq(qt.codes, qj.codes)
        _eq(qt.scale, qj.scale)
        # integer-valued codes on the 8-bit grid
        assert torch.equal(qt.codes, torch.round(qt.codes))
        assert float(qt.codes.abs().max()) <= 255


@pytest.mark.parametrize("per_channel", [True, False])
def test_program_weights_p8_bitwise(per_channel):
    rng = np.random.default_rng(8)
    w = rng.standard_normal((3, 17, 40)).astype(np.float32) * 0.05
    qt = tquant.program_weights(torch.from_numpy(w), 8, per_channel)
    qj = _program_j(jnp.asarray(w), 8, per_channel)
    _eq(qt.codes, qj.codes)
    _eq(qt.scale, qj.scale)


@pytest.mark.parametrize("shape,axis", [((5, 7), -1), ((5, 8), -1),
                                        ((3, 9, 4), -2), ((2, 9), 0),
                                        ((4, 1), -1)])
def test_pack_int4_unpack_int4_bitwise(shape, axis):
    """Byte kp holds code 2kp low and 2kp+1 high; odd K is zero-padded."""
    c = np.random.default_rng(len(shape)).integers(-7, 8, shape).astype(
        np.int8)
    pt = tquant.pack_int4(torch.from_numpy(c), axis)
    pj = jquant.pack_int4(jnp.asarray(c), axis)
    _eq(pt, pj)
    assert pt.dtype == torch.int8
    assert pt.shape[axis] == (shape[axis] + 1) // 2
    ut = tquant.unpack_int4(pt, shape[axis], axis)
    _eq(ut, jquant.unpack_int4(pj, shape[axis], axis))
    np.testing.assert_array_equal(ut.numpy(), c)
    # the byte layout: 1 low, -2 high -> 0xE1; -7 low, 7 high -> 0x79
    pair = tquant.pack_int4(torch.tensor([[1, -2, -7, 7]], dtype=torch.int8),
                            -1)
    assert pair.view(torch.uint8).tolist() == [[0xE1, 0x79]]


@pytest.mark.parametrize("scale", [None, 0.7])
@pytest.mark.parametrize("bits", [3, 6, 8])
def test_readout_bitwise(bits, scale):
    x = np.random.default_rng(bits).standard_normal((6, 33)).astype(
        np.float32)
    yt = tquant.readout(torch.from_numpy(x), bits, scale)
    yj = jquant.readout(jnp.asarray(x), bits, scale)
    _eq(yt, yj)


def _stack_members(bits: int, per_channel: bool, grad: bool):
    """Members of uneven widths (40, 128, 7) programmed in both packages."""
    rng = np.random.default_rng(bits)
    ws = [rng.standard_normal((24, n)).astype(np.float32) for n in (40, 128, 7)]
    t = [tquant.program_weights(torch.from_numpy(w).requires_grad_(grad),
                                bits, per_channel) for w in ws]
    j = [jquant.program_weights(jnp.asarray(w), bits, per_channel)
         for w in ws]
    return t, j


@pytest.mark.parametrize("bits", [6, 8])
@pytest.mark.parametrize("per_channel", [True, False])
def test_stack_group_matches_reference(bits, per_channel):
    """Codes, (G, 1, n_to) scales and the STE term equal the JAX
    package's; uneven widths zero-padded to n_to (scale 1.0 there)."""
    t, j = _stack_members(bits, per_channel, grad=True)
    qt = tquant.stack_group(t, 128)
    qj = jquant.stack_group(j, 128)
    assert qt.bits == qj.bits == bits
    _eq(qt.codes.detach(), qj.codes)
    _eq(qt.scale, qj.scale)
    assert tuple(qt.scale.shape) == (3, 1, 128)
    assert float(qt.scale[2, 0, 7:].min()) == 1.0
    assert not qt.codes[0, :, 40:].any() and not qt.codes[2, :, 7:].any()
    if bits == 8:          # float32 storage: the codes carry their STE
        assert qt.ste is None and qj.ste is None
    else:
        _eq(qt.ste.detach(), qj.ste)
        assert qt.ste.requires_grad


def test_stack_group_without_gradient_has_no_ste():
    t, _ = _stack_members(6, True, grad=False)
    assert tquant.stack_group(t, 128).ste is None


def test_stack_group_raises_the_reference_errors():
    t, j = _stack_members(6, True, grad=False)
    t8, j8 = _stack_members(5, True, grad=False)
    bank = tquant.QuantizedTensor(codes=t[0].codes[None], scale=t[0].scale,
                                  bits=6)
    jbank = jquant.QuantizedTensor(codes=j[0].codes[None], scale=j[0].scale,
                                   bits=6)
    for (mine, n_to), (ref, _) in (
            (([], 128), ([], 128)),
            (([t[0], t8[0]], 128), ([j[0], j8[0]], 128)),
            (([bank], 128), ([jbank], 128)),
            ((t, 64), (j, 64))):
        with pytest.raises(ValueError) as ej:
            jquant.stack_group(ref, n_to)
        with pytest.raises(ValueError) as et:
            tquant.stack_group(mine, n_to)
        assert str(et.value) == str(ej.value)

