"""The bf16x3 precision tier of the port (the default of ``--dft-precision``,
as in fpm_tpu) against fpm_tpu's, on the CPU, from numpy-seeded inputs.

* The bf16 split and the host-split DFT matrices (the plain versions' pairs
  and the CUDA kernels' packed layout) are bitwise fpm_tpu's
  ``_bf16_split`` and ``_block_dft_mats(n, b, lo, "bf16x3")``.
* The port's product (:func:`fpm_torch.ops.kernels.cmm_bf16x3`) is within
  1e-6 relative of ``_mm_fns("bf16x3")``'s ``mm_left`` / ``mm_right``: the
  same three exact bf16 products per pair, summed in another order.
* The plain K1, K2 (exact and lazy) and K3 at bf16x3 against fpm_tpu's
  Pallas kernels in interpret mode at bf16x3, and ``reconstruct`` and the
  sharded sweeps on meshes (4,1), (2,2) with both packages' default options:
  rel-max 5e-5 on the object spectrum, 5e-4 on the pupil
  (tests/test_pallas.py:15-17's limits for this tier), metrics rtol 1e-3.
* The eager route has no DFT products: the tier changes nothing there.

The CUDA kernels at bf16x3 are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpm_tpu.parallel as jpar
from fpm_torch import parallel as tpar
from fpm_torch.models import epry as tepry
from fpm_torch.ops import kernels as tk
from fpm_tpu.data.simulate import synthetic_dataset
from fpm_tpu.geometry import pupil_radius, pupil_support
from fpm_tpu.models import epry as jepry
from fpm_tpu.ops import pallas_kernels as jk

TOL_O, TOL_P, TOL_M = 5e-5, 5e-4, 1e-3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def bits(x) -> np.ndarray:
    """The bit patterns of a float32 or bfloat16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.itemsize == 2 else np.int32)


def seeded_f32(seed, shape=(64, 96)):
    """Normal values over many magnitudes (1e-30 to 1e30), both signs, with
    zeros, a large value near bf16's top and powers of two mixed in."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-30, 31, size=shape)
    x.flat[:6] = [0.0, -0.0, 1.0, -2.0 ** -120, 3.0e38, 2.0 ** 100]
    return x.astype(np.float32)


# ----------------------------------------------------------------- the split


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_is_bitwise_fpm_tpus(seed):
    x = seeded_f32(seed)
    hi, lo = tk.bf16_split(torch.from_numpy(x))
    jhi, jlo = jk._bf16_split(jnp.asarray(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(hi), bits(jhi))
    np.testing.assert_array_equal(bits(lo), bits(jlo))


def _unpack(layout: np.ndarray, k: int) -> list[np.ndarray]:
    """The four bf16 planes (re hi, re lo, im hi, im lo), as float32, of a
    kernel split layout (rows, ceil(k/2), 4) int32."""
    words = layout.view(np.uint32)
    planes = []
    for w in range(4):
        pairs = np.stack([words[..., w] & 0xFFFF, words[..., w] >> 16], axis=-1)
        planes.append((pairs.reshape(layout.shape[0], -1)[:, :k].astype(np.uint32) << 16)
                      .view(np.float32))
    return planes


@pytest.mark.parametrize("n,radius", [(90, 30), (64, 20), (16, 4), (16, 0)])
def test_host_split_matrices_are_bitwise_fpm_tpus_blocks(n, radius):
    """Ai, Bi, Af, Bf's (hi, lo) as the plain versions take them, and as the
    CUDA kernels take them (Biᵀ, Bfᵀ packed in bf16x2 words), against the
    [[Re, −Im], [Im, Re]] blocks fpm_tpu pre-splits on the host."""
    b, lo = tk.bbox_extent(n, radius)
    jb, jlo = jk._support_bbox(n, radius)
    j = [np.asarray(m).astype(np.float32) for m in jk._block_dft_mats(n, jb, jlo, "bf16x3")]
    np8, nl, bl = jk._round_up(n, 8), jk._round_up(n, 128), jk._round_up(jb, 128)
    # (re, im) of each matrix in fpm_tpu's hi and lo blocks, in Ai, Bi, Af, Bf order.
    want = [
        [(m[:n, :b], m[np8:np8 + n, :b]) for m in j[0:2]],
        [(m[:b, :n], m[:b, nl:nl + n]) for m in j[2:4]],
        [(m[:b, :n], m[jb:jb + b, :n]) for m in j[4:6]],
        [(m[:n, :b], m[:n, bl:bl + b]) for m in j[6:8]],
    ]
    pairs = tk._block_dft_mats(n, b, lo, "bf16x3")
    plain = tk._block_dft_mats(n, b, lo)
    for (hi, low), w, m, transposed in zip(pairs, want, plain, (False, True, False, True)):
        for got, (re, im) in zip((hi, low), w):
            np.testing.assert_array_equal(bits(got.real.copy()), bits(re))
            np.testing.assert_array_equal(bits(got.imag.copy()), bits(im))
        kmat = m.T if transposed else m
        planes = _unpack(tk.split_layout(kmat), kmat.shape[1])
        (hre, him), (lre, lim) = ((x.T, y.T) if transposed else (x, y) for x, y in w)
        for got, ref in zip(planes, (hre, lre, him, lim)):
            np.testing.assert_array_equal(bits(got), bits(ref))


def test_split_layout_pads_an_odd_contraction_with_zeros():
    m = (np.arange(15, dtype=np.float32) + 1j).reshape(3, 5).astype(np.complex64)
    layout = tk.split_layout(m)
    assert layout.shape == (3, 3, 4) and layout.dtype == np.int32
    assert (layout[:, 2].view(np.uint32) >> 16 == 0).all()      # index 5 of each row
    np.testing.assert_array_equal(_unpack(layout, 5)[0], m.real)


# --------------------------------------------------------------- the product


@pytest.mark.parametrize("seed", [0, 1])
def test_product_matches_fpm_tpus_mm_left_and_mm_right(seed):
    """One static complex matrix times a dynamic one, both sides, against the
    JAX package's real block product of the same tier."""
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
            np.complex64)

    a, x, b = cplx(24, 40), cplx(40, 32), cplx(32, 48)
    mm_left, mm_right, _ = jk._mm_fns("bf16x3")

    def split_block(blk):
        return jk._bf16_split(jnp.asarray(blk))

    l_blk = np.block([[a.real, -a.imag], [a.imag, a.real]]).astype(np.float32)
    got = jnp.asarray(np.concatenate([x.real, x.imag]).astype(np.float32))
    left = np.asarray(mm_left(split_block(l_blk), got))
    ours = tk.cmm_bf16x3(tk._csplit(torch.from_numpy(a)), torch.from_numpy(x)).numpy()
    assert rel(ours, left[:24] + 1j * left[24:]) < 1e-6

    r_blk = np.block([[b.real, b.imag], [-b.imag, b.real]]).astype(np.float32)
    dyn = jnp.asarray(np.concatenate([x.real, x.imag], axis=1).astype(np.float32))
    right = np.asarray(mm_right(dyn, split_block(r_blk)))
    ours = tk.cmm_bf16x3(torch.from_numpy(x), tk._csplit(torch.from_numpy(b))).numpy()
    assert rel(ours, right[:, :48] + 1j * right[:, 48:]) < 1e-6
    # Only the three passes: one hi·hi pass alone is far off.
    one_pass = (tk._csplit(torch.from_numpy(x))[0] @ tk._csplit(torch.from_numpy(b))[0]).numpy()
    assert rel(one_pass, right[:, :48] + 1j * right[:, 48:]) > 1e-3


# ----------------------------------------------- the kernels' plain versions


def _planes_np(z):
    return np.stack([z.real, z.imag]).astype(np.float32)


def _state(ds):
    """A state that is not the init: a spectrum after one sweep, a pupil with
    phase; as float32 planes, with the support."""
    start = jepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=1, dtype="complex64")
    rng = np.random.default_rng(0)
    pupil = start.pupil * np.exp(0.3j * rng.standard_normal(start.pupil.shape))
    return (_planes_np(start.obj_f_centered), _planes_np(pupil),
            pupil_support(ds.cfg).astype(np.float32))


def _common(cfg):
    return dict(np_size=cfg.np_size, n_large=cfg.n_large, delta1=cfg.delta1, delta2=cfg.delta2,
                eps=cfg.eps, pupil_radius=pupil_radius(cfg), collect_metrics=True)


def _check(got, ref, tol_m=TOL_M):
    (go, gp, gm), (ro, rp, rm) = (x.numpy() for x in got), (np.asarray(x) for x in ref)
    assert go.shape == ro.shape and gp.shape == rp.shape and go.dtype == np.float32
    assert rel(go, ro) < TOL_O
    assert rel(gp, rp) < TOL_P
    np.testing.assert_allclose(gm, rm, rtol=tol_m)


def _as_jax(arrays):
    return (jnp.asarray(a) for a in arrays)


def _as_torch(arrays):
    return (torch.tensor(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("global_max", ["exact", "lazy"])
def test_plain_k2_matches_pallas(global_max):
    ds = synthetic_dataset(np_size=16, grid=5, seed=5, aberrated_pupil=True)
    amps, starts = jepry._sorted_device_inputs(ds.images, ds.geom, jnp.complex64)
    args = (*_state(ds), np.asarray(amps), np.asarray(starts).reshape(-1))
    kw = dict(_common(ds.cfg), global_max=global_max)
    ref = jk.fused_epry_sweep(*_as_jax(args), interpret=True, dft_precision="bf16x3", **kw)
    _check(tk.fused_epry_sweep(*_as_torch(args), dft_precision="bf16x3", **kw), ref)
    _check(tk.fused_epry_sweep_plain(*_as_torch(args), **kw), ref)   # the default tier


@pytest.mark.parametrize("np_size,chunk", [(16, 8), (64, 6)])
def test_plain_k1_matches_pallas(np_size, chunk):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=5, aberrated_pupil=True)
    amps, starts = jepry._sorted_device_inputs(ds.images, ds.geom, jnp.complex64)
    k = amps.shape[0]
    perm, mask, n_chunks = tepry.chunk_schedule(k, chunk, "strided")
    a = np.concatenate([np.asarray(amps), np.zeros((perm.size - k, np_size, np_size),
                                                   np.float32)])
    s = np.concatenate([np.asarray(starts), np.zeros((perm.size - k, 2), np.int32)])
    args = (*_state(ds), a[perm].reshape(n_chunks, chunk, np_size, np_size),
            s[perm].reshape(-1), (mask > 0).astype(np.int32))
    kw = dict(_common(ds.cfg), pupil_step_scale=1.0)
    ref = jk.fused_epry_chunked(*_as_jax(args), interpret=True, dft_precision="bf16x3", **kw)
    _check(tk.fused_epry_chunked(*_as_torch(args), **kw), ref)


def test_plain_k3_matches_pallas():
    """One chunk of the chunk-8 schedule (one masked dummy) on the whole
    spectrum."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=5, aberrated_pupil=True)
    o, p, sup = _state(ds)
    order = ds.geom.schedule
    k = len(order)
    perm, _, n_chunks = tepry.chunk_schedule(k, 8, "strided")
    sel = perm.reshape(n_chunks, 8)[1]
    valid = (sel < k).astype(np.int32)
    assert 0 < valid.sum() < 8
    sel = np.where(sel < k, sel, 0)
    amps = (np.sqrt(np.asarray(ds.images, np.float64))[order][sel]
            * valid[:, None, None]).astype(np.float32)
    starts = (ds.geom.crop_start[order][sel] * valid[:, None]).astype(np.int32)
    args = (o, p, sup, amps, starts.reshape(-1), valid)
    kw = {key: v for key, v in _common(ds.cfg).items() if key != "n_large"}
    kw.update(n_rows=o.shape[1], n_cols=o.shape[2])
    ref = jk.fused_chunk_increments(*_as_jax(args), interpret=True, dft_precision="bf16x3",
                                    **kw)
    _check(tk.fused_chunk_increments(*_as_torch(args), **kw), ref)


def test_wrappers_refuse_another_tier():
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    amps, starts = jepry._sorted_device_inputs(ds.images, ds.geom, jnp.complex64)
    args = (*_state(ds), np.asarray(amps), np.asarray(starts).reshape(-1))
    for fn in (tk.fused_epry_sweep, tk.fused_epry_sweep_plain):
        with pytest.raises(ValueError, match="'bf16x3' or 'highest'"):
            fn(*_as_torch(args), dft_precision="tf32", **_common(ds.cfg))


# ----------------------------------------------- the slice, default options


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=9)


def _assert_close(got, ref):
    assert rel(got.obj_f_centered, ref.obj_f_centered) < TOL_O
    assert rel(got.pupil, ref.pupil) < TOL_P
    for key in ("data_residual", "update_norm"):
        np.testing.assert_allclose(got.metrics[key], ref.metrics[key], rtol=TOL_M)


@pytest.mark.parametrize("kw", [dict(), dict(global_max="lazy"),
                                dict(mode="batched", chunk_size=8)])
def test_reconstruct_with_default_options_matches_fpm_tpu(ds, kw):
    """Both packages at their defaults (bf16x3) on the kernel route."""
    common = dict(iterations=2, dtype="complex64", use_pallas=True, **kw)
    ref = jepry.reconstruct(ds.images, ds.geom, ds.cfg, **common)
    got = tepry.reconstruct(ds.images, ds.geom, ds.cfg, device="cpu", **common)
    _assert_close(got, ref)


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_mesh_with_default_options_matches_fpm_tpu(ds, led, tile):
    """K3's plain version on a mesh of CPU ranks against fpm_tpu's Pallas
    kernel on the same mesh of virtual devices, both at their defaults."""
    if len(jax.devices()) < led * tile:
        pytest.skip(f"needs {led * tile} (virtual) JAX devices")
    kw = dict(iterations=2, dtype="complex64", chunk_size=8, use_pallas=True)
    t_fn = tpar.reconstruct_led_sharded if tile == 1 else tpar.reconstruct_tile_sharded
    j_fn = jpar.reconstruct_led_sharded if tile == 1 else jpar.reconstruct_tile_sharded
    got = t_fn(ds.images, ds.geom, ds.cfg,
               mesh=tpar.make_mesh(led=led, tile=tile, devices=["cpu"] * (led * tile)), **kw)
    ref = j_fn(ds.images, ds.geom, ds.cfg,
               mesh=jpar.make_mesh(led=led, tile=tile, devices=jax.devices()[:led * tile]),
               **kw)
    _assert_close(got, ref)


@pytest.mark.parametrize("kw", [dict(), dict(mode="batched", chunk_size=8)])
def test_the_eager_route_is_bitwise_the_same_under_either_tier(ds, kw):
    common = dict(iterations=2, dtype="complex64", device="cpu", **kw)
    a = tepry.reconstruct(ds.images, ds.geom, ds.cfg, dft_precision="bf16x3", **common)
    b = tepry.reconstruct(ds.images, ds.geom, ds.cfg, dft_precision="highest", **common)
    for key in ("obj_crop", "obj_f_centered", "pupil"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    np.testing.assert_array_equal(a.metrics["data_residual"], b.metrics["data_residual"])


def test_k3_d_lies_within_1e_5_of_fpm_tpus_at_both_tiers(np_size=64, chunk=6):
    """Fault F2 on the CPU: on one K3 call (chunk 1 of the strided schedule,
    the state after one sweep) the port's plain d and fpm_tpu's interpret-mode
    d, two float32 summation orders of one function, lie within 1e-5 of
    each other at either tier (measured 3.5e-6 at bf16x3, 5.2e-6 at highest),
    while the bf16x3 tier itself lies farther than that from highest on d
    (1.9e-5): d's terms cancel, so its relative error is many times the
    products'."""
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=5, aberrated_pupil=True)
    o, p, sup = _state(ds)
    order = ds.geom.schedule
    k = len(order)
    perm, _, n_chunks = tepry.chunk_schedule(k, chunk, "strided")
    sel = perm.reshape(n_chunks, chunk)[1]
    valid = (sel < k).astype(np.int32)
    sel = np.where(sel < k, sel, 0)
    amps = (np.sqrt(np.asarray(ds.images, np.float64))[order][sel]
            * valid[:, None, None]).astype(np.float32)
    starts = (ds.geom.crop_start[order][sel] * valid[:, None]).astype(np.int32)
    args = (o, p, sup, amps, starts.reshape(-1), valid)
    kw = {key: v for key, v in _common(ds.cfg).items() if key != "n_large"}
    kw.update(n_rows=o.shape[1], n_cols=o.shape[2])
    d = {}
    for tier in ("bf16x3", "highest"):
        d["port", tier] = tk.fused_chunk_increments(*_as_torch(args), dft_precision=tier,
                                                    **kw)[0].numpy()
        d["fpm_tpu", tier] = np.asarray(jk.fused_chunk_increments(
            *_as_jax(args), interpret=True, dft_precision=tier, **kw)[0])
        assert rel(d["port", tier], d["fpm_tpu", tier]) < 1e-5
    for pkg in ("port", "fpm_tpu"):
        assert rel(d[pkg, "bf16x3"], d[pkg, "highest"]) > 1e-5
