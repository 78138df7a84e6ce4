"""K2's operand layouts at bf16x3 (``fpm_torch/ops/kernels.py``
``tile_layout``, ``row_layout``, ``_k2_mats``): every bf16x2 word of the
split layout (``split_layout``, the words of the bf16x3 products of the JAX
package and of the other kernels) lies where ``csrc/epry_common.cuh`` reads
it (``TileA``, ``RowB``; the device's ``put_tile`` and ``put_row`` write the
dynamic operands by the same rule), and the padding to whole k-steps and
tiles is zeros, so no load needs a guard. On the CPU; inputs from a numpy
seed; the comparison is of bits."""

import numpy as np
import pytest

from fpm_torch.ops import kernels

SHAPES = [(90, 64), (64, 90), (21, 37), (16, 16), (112, 200), (200, 200)]


def matrix(rows, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, k)) + 1j * rng.standard_normal((rows, k))).astype(
        np.complex64)


def split_words(m, rows, pairs):
    """split_layout's words as (part, row, pair), zero-padded."""
    w = kernels.split_layout(m).view(np.uint32).transpose(2, 0, 1)
    out = np.zeros((4, rows, pairs), np.uint32)
    out[:, :w.shape[1], :w.shape[2]] = w
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_layout_is_the_split_layout_by_tiles(shape):
    rows, k = shape
    mt, ks = -(-rows // 16), -(-k // 16)
    t = kernels.tile_layout(matrix(rows, k)).view(np.uint32)
    assert t.size == mt * ks * 4 * 32 * 4
    # unit ((mt·ks + s)·4 + part)·32 + g·4 + t, word (row half) + 2·(pair half)
    got = t.reshape(mt, ks, 4, 8, 4, 2, 2).transpose(2, 0, 6, 3, 1, 5, 4)
    np.testing.assert_array_equal(got.reshape(4, 16 * mt, 8 * ks),
                                  split_words(matrix(rows, k), 16 * mt, 8 * ks))


@pytest.mark.parametrize("shape", SHAPES)
def test_row_layout_is_the_split_layout_by_rows(shape):
    rows, k = shape
    ks, more = -(-k // 16), rows + 8
    r = kernels.row_layout(matrix(rows, k), more).view(np.uint32).reshape(more, 8 * ks + 1, 4)
    assert not r[:, -1].any()                      # the odd unit that ends each row
    # unit s·8 + 2t + (re, im), word (hi, lo)·2 + (pair half)
    got = r[:, :-1].reshape(more, ks, 4, 2, 2, 2).transpose(3, 4, 0, 1, 5, 2)
    np.testing.assert_array_equal(got.reshape(4, more, 8 * ks),
                                  split_words(matrix(rows, k), more, 8 * ks))


def test_k2_mats_are_the_layouts_of_the_dft_matrices():
    n, b, lo = 90, 64, 13
    ai, bi, af, bf = kernels._block_dft_mats(n, b, lo)
    got = kernels._k2_mats(n, b, lo, kernels.torch.device("cpu"))
    want = (kernels.row_layout(ai, n + 8), kernels.tile_layout(bi.T), kernels.tile_layout(af),
            kernels.tile_layout(bf.T))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].numel() == 4 * (n + 8) * (8 * 4 + 1)
    assert got[1].numel() == 6 * 4 * 512 and got[2].numel() == 4 * 6 * 512   # tiles × steps
