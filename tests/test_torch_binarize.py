"""The port's binarization primitives against the JAX reference, word for
word (``repro_torch.core.binarize`` vs ``repro.core.binarize``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as JB
from repro_torch import convert as CV
from repro_torch.core import binarize as TB


def _real(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_word_constants():
    assert TB.WORD_BITS == JB.WORD_BITS
    for k in (1, 31, 32, 33, 64, 8192, 8193):
        assert TB.packed_width(k) == JB.packed_width(k)


@pytest.mark.parametrize("shape,multiple,axis,value", [
    ((3, 5), 4, 1, 0), ((7, 2), 8, 0, 1), ((2, 3, 4), 4, -1, 0)])
def test_pad_to_multiple(shape, multiple, axis, value):
    x = _real(0, shape)
    want = np.asarray(JB.pad_to_multiple(jnp.asarray(x), multiple, axis,
                                         value))
    got = TB.pad_to_multiple(torch.from_numpy(x), multiple, axis, value)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sign_pm1_zero_is_plus_one():
    x = np.array([-2.0, -0.0, 0.0, 1e-9, 3.0], np.float32)
    np.testing.assert_array_equal(TB.sign_pm1(torch.from_numpy(x)).numpy(),
                                  np.asarray(JB.sign_pm1(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(4, 1), (3, 31), (2, 32), (5, 33),
                                   (2, 3, 100), (1, 8192)])
def test_pack_unpack_bits(shape):
    x = _real(sum(shape), shape)
    want = np.asarray(JB.pack_bits(jnp.asarray(x)))
    got = TB.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(CV.words_to_numpy(got), want)
    k = shape[-1]
    np.testing.assert_array_equal(
        TB.unpack_bits(got, k).numpy(),
        np.asarray(JB.unpack_bits(jnp.asarray(want), k)))


def test_words_round_trip_high_bit():
    words = np.array([[0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]], np.uint32)
    t = CV.words_to_torch(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(CV.words_to_numpy(t), words)
    np.testing.assert_array_equal(TB.popcount32(t).numpy(),
                                  [[0, 1, 31, 1, 32]])


@pytest.mark.parametrize("m,n,k", [(1, 10, 33), (5, 7, 64), (9, 40, 300)])
def test_packed_matmul(m, n, k):
    a = JB.pack_bits(jnp.asarray(_real(m, (m, k))))
    b = JB.pack_bits(jnp.asarray(_real(n, (n, k))))
    want = np.asarray(JB.packed_matmul(a, b, k))
    got = TB.packed_matmul(CV.words_to_torch(a), CV.words_to_torch(b), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_matmul_chunks_rows(monkeypatch):
    """The row chunking bounds memory and changes nothing."""
    monkeypatch.setattr(TB, "_MATMUL_CHUNK_ELEMS", 7)
    a = TB.pack_bits(torch.from_numpy(_real(1, (13, 70))))
    b = TB.pack_bits(torch.from_numpy(_real(2, (5, 70))))
    want = np.asarray(JB.packed_matmul(
        jnp.asarray(CV.words_to_numpy(a)), jnp.asarray(CV.words_to_numpy(b)),
        70))
    np.testing.assert_array_equal(TB.packed_matmul(a, b, 70).numpy(), want)


@pytest.mark.parametrize("shape", [(2, 3), (2, 4, 4, 3), (1, 40)])
def test_bitplanes(shape):
    x = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        TB.bitplanes_uint8(torch.from_numpy(x)).numpy(),
        np.asarray(JB.bitplanes_uint8(jnp.asarray(x))))
    np.testing.assert_array_equal(
        CV.words_to_numpy(TB.pack_bitplanes_uint8(torch.from_numpy(x))),
        np.asarray(JB.pack_bitplanes_uint8(jnp.asarray(x))))
