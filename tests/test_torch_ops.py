"""ops layer of the port against fpm_tpu.ops: shifts, patch crop/paste and
the FFT conventions (complex128, ≤ 1e-12), plus the kernels' host-built
helpers (bbox and shift-folded DFT matrices), which must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpm_torch.ops as tops
import fpm_tpu.ops as jops
from fpm_torch.ops import kernels as tk
from fpm_tpu.ops import pallas_kernels as jk

RNG = np.random.default_rng(7)


def rand_c(*shape):
    return RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)


@pytest.mark.parametrize("shape", [(16, 16), (3, 90, 90), (2, 24, 40)])
def test_shifts_match(shape):
    x = rand_c(*shape)
    for t_fn, j_fn in ((tops.fftshift2d, jops.fftshift2d), (tops.ifftshift2d, jops.ifftshift2d)):
        np.testing.assert_array_equal(t_fn(torch.from_numpy(x)).numpy(),
                                      np.asarray(j_fn(jnp.asarray(x))))


def test_crop_and_paste_match():
    spec = rand_c(48, 48)
    patch = rand_c(16, 16)
    start = np.array([5, 29], np.int32)
    got = tops.crop_patch(torch.from_numpy(spec), start, 16).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.crop_patch(jnp.asarray(spec),
                                                                  jnp.asarray(start), 16)))
    t = torch.from_numpy(spec.copy())
    out = tops.paste_patch_add(t, torch.from_numpy(patch), start)
    assert out is t                       # in place (documented)
    ref = jops.paste_patch_add(jnp.asarray(spec), jnp.asarray(patch), jnp.asarray(start))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("start", [(-3, 40), (45, -7), (100, 100)])
def test_crop_and_paste_clamp_like_dynamic_slice(start):
    spec = rand_c(48, 48)
    patch = rand_c(16, 16)
    got = tops.crop_patch(torch.from_numpy(spec), start, 16).numpy()
    ref = jops.crop_patch(jnp.asarray(spec), jnp.asarray(start, jnp.int32), 16)
    np.testing.assert_array_equal(got, np.asarray(ref))
    out = tops.paste_patch_add(torch.from_numpy(spec.copy()), torch.from_numpy(patch), start)
    ref = jops.paste_patch_add(jnp.asarray(spec), jnp.asarray(patch),
                               jnp.asarray(start, jnp.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [16, 90, 128])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_fft_conventions_match(n, batch):
    x = rand_c(*batch, n, n)
    for t_fn, j_fn in ((tops.fft2, jops.fft2), (tops.ifft2, jops.ifft2)):
        got = t_fn(torch.from_numpy(x)).numpy()
        ref = np.asarray(j_fn(jnp.asarray(x), impl="xla"))
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-12
    # the inverse carries 1/N²; the round trip is the identity
    back = tops.ifft2(tops.fft2(torch.from_numpy(x))).numpy()
    assert np.abs(back - x).max() <= 1e-12


@pytest.mark.parametrize("dtype,cdtype", [(torch.float64, torch.complex128),
                                          (torch.float32, torch.complex64)])
def test_real_input_promoted(dtype, cdtype):
    x = torch.from_numpy(RNG.standard_normal((16, 16))).to(dtype)
    for fn in (tops.fft2, tops.ifft2):
        y = fn(x)
        assert y.dtype == cdtype
        np.testing.assert_allclose(y.numpy(), fn(x.to(cdtype)).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("n,radius", [(90, 30), (64, 20), (16, 4), (16, 7), (90, 0),
                                      (100, 45), (200, 30)])
def test_support_bbox_matches(n, radius):
    assert tk._support_bbox(n, radius) == jk._support_bbox(n, radius)
    b, lo = tk.bbox_extent(n, radius)
    jb, jlo = jk._support_bbox(n, radius)
    assert (b, lo) == (min(jb, n - jlo), jlo)


@pytest.mark.parametrize("n,radius", [(90, 30), (64, 20), (16, 4)])
def test_dft_matrices_match_the_pallas_blocks(n, radius):
    """The port's four complex matrices are exactly the complex parts of the
    JAX kernel's block-real matrices ('highest' tier)."""
    b, lo = tk.bbox_extent(n, radius)
    jb, jlo = jk._support_bbox(n, radius)
    ai, bi, af, bf = tk._block_dft_mats(n, b, lo)
    l_inv, r_inv, l_fwd, r_fwd = jk._block_dft_mats(n, jb, jlo, "highest")
    np8, nl, bl = jk._round_up(n, 8), jk._round_up(n, 128), jk._round_up(jb, 128)
    np.testing.assert_array_equal(ai.real, l_inv[:n, :b])
    np.testing.assert_array_equal(ai.imag, l_inv[np8:np8 + n, :b])
    np.testing.assert_array_equal(bi.real, r_inv[:b, :n])
    np.testing.assert_array_equal(bi.imag, r_inv[:b, nl:nl + n])
    np.testing.assert_array_equal(af.real, l_fwd[:b, :n])
    np.testing.assert_array_equal(af.imag, l_fwd[jb:jb + b, :n])
    np.testing.assert_array_equal(bf.real, r_fwd[:n, :b])
    np.testing.assert_array_equal(bf.imag, r_fwd[:n, bl:bl + b])
    assert ai.dtype == np.complex64 and ai.flags.c_contiguous


def test_dft_matrices_are_the_shifted_bbox_transforms():
    """Ai·Z·Bi is ifft2(ifftshift(.)) of a bbox-supported centered patch;
    Af·Y·Bf is the bbox of fftshift(fft2(Y))."""
    n, radius = 32, 9
    b, lo = tk.bbox_extent(n, radius)
    ai, bi, af, bf = (m.astype(np.complex128) for m in tk._block_dft_mats(n, b, lo))
    z = np.zeros((n, n), complex)
    z[lo:lo + b, lo:lo + b] = rand_c(b, b)
    np.testing.assert_allclose(ai @ z[lo:lo + b, lo:lo + b] @ bi,
                               np.fft.ifft2(np.fft.ifftshift(z)), atol=1e-6)
    y = rand_c(n, n)
    np.testing.assert_allclose(af @ y @ bf, np.fft.fftshift(np.fft.fft2(y))[lo:lo + b, lo:lo + b],
                               atol=1e-4)
