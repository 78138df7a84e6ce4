"""The plain PyTorch versions of kernels K1 and K2 (float32, on the CPU)
against fpm_tpu's Pallas kernels run in interpret mode, with the cases and
tolerances of tests/test_pallas.py: rel-max 1e-5 on the object spectrum,
1e-4 on the pupil, metrics rtol 1e-4 (f32 against f32: the two differ in
summation order only). The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpm_torch.geometry import pupil_radius as t_pupil_radius
from fpm_torch.models import epry as tepry
from fpm_torch.ops import kernels as tk
from fpm_tpu.data.simulate import synthetic_dataset
from fpm_tpu.models.epry import EPRYOptions, _sorted_device_inputs
from fpm_tpu.models.epry import reconstruct as jreconstruct
from fpm_tpu.ops import pallas_kernels as jk

TOL_O, TOL_P, TOL_M = 1e-5, 1e-4, 1e-4


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def both(ds, iterations=2, **kw):
    ref = jreconstruct(ds.images, ds.geom, ds.cfg, iterations=iterations, dtype="complex64",
                       use_pallas=True, dft_precision="highest", **kw)
    got = tepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=iterations,
                            dtype="complex64", use_pallas=True, device="cpu", **kw)
    return ref, got


def assert_close(ref, got):
    assert rel(got.obj_f_centered, ref.obj_f_centered) < TOL_O
    assert rel(got.pupil, ref.pupil) < TOL_P
    for key in ("data_residual", "update_norm"):
        np.testing.assert_allclose(got.metrics[key], ref.metrics[key], rtol=TOL_M)


@pytest.mark.parametrize("np_size,kw", [
    (16, dict(global_max="exact")),                      # K2
    (16, dict(global_max="lazy")),                       # K2, frozen max|O|
    (16, dict(mode="batched", chunk_size=7)),            # K1: 25 LEDs → 4 chunks, 3 dummies
    (16, dict(mode="batched", chunk_size=0)),            # K1: whole-sweep Jacobi
    (64, dict(mode="batched", chunk_size=6)),            # K1: bbox b < Np
])
def test_plain_kernels_match_pallas(np_size, kw):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    assert_close(*both(ds, **kw))


def test_sequential_bbox_pupil_exactly_zero_outside_support():
    """Np 64: bbox (48, 8) narrower than the patch; the pupil stays exactly 0
    outside the NA support."""
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    b, lo = tk.bbox_extent(64, t_pupil_radius(ds.cfg))
    assert b < 64
    ref, got = both(ds)
    assert_close(ref, got)
    from fpm_torch.geometry import pupil_support

    outside = pupil_support(ds.cfg) == 0
    assert np.abs(got.pupil[outside]).max() == 0.0


def _planes_np(z):
    return np.stack([z.real, z.imag]).astype(np.float32)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_wrappers_match_pallas_on_the_same_planes(mode):
    """One direct call of each port wrapper against fpm_tpu's
    fused_epry_* (interpret=True) on identical planes, from a state that
    is not the init (a pupil with phase, a spectrum after one sweep)."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=5, aberrated_pupil=True)
    cfg = ds.cfg
    start = jreconstruct(ds.images, ds.geom, cfg, iterations=1, dtype="complex64")
    rng = np.random.default_rng(0)
    pupil = start.pupil * np.exp(0.3j * rng.standard_normal(start.pupil.shape))
    o_pl, p_pl = _planes_np(start.obj_f_centered), _planes_np(pupil)
    from fpm_tpu.geometry import pupil_support

    sup = pupil_support(cfg).astype(np.float32)
    opts = EPRYOptions.from_config(cfg, dtype="complex64", mode=mode, chunk_size=8,
                                   use_pallas=True, dft_precision="highest")
    amps, starts = _sorted_device_inputs(ds.images, ds.geom, jnp.complex64)
    common = dict(np_size=cfg.np_size, n_large=cfg.n_large, delta1=cfg.delta1,
                  delta2=cfg.delta2, eps=cfg.eps, pupil_radius=opts.pupil_radius,
                  collect_metrics=True)
    if mode == "sequential":
        args = (np.asarray(amps), np.asarray(starts).reshape(-1))
        ref = jk.fused_epry_sweep(*(jnp.asarray(a) for a in (o_pl, p_pl, sup, *args)),
                                  interpret=True, dft_precision="highest", **common)
        got = tk.fused_epry_sweep(*(torch.tensor(np.asarray(a))
                                    for a in (o_pl, p_pl, sup, *args)), **common)
    else:
        k = amps.shape[0]
        perm, mask, n_chunks = tepry.chunk_schedule(k, 8, "strided")
        a = np.concatenate([np.asarray(amps), np.zeros((perm.size - k, 16, 16), np.float32)])
        s = np.concatenate([np.asarray(starts), np.zeros((perm.size - k, 2), np.int32)])
        args = (a[perm].reshape(n_chunks, 8, 16, 16), s[perm].reshape(-1),
                (mask > 0).astype(np.int32))
        ref = jk.fused_epry_chunked(*(jnp.asarray(x) for x in (o_pl, p_pl, sup, *args)),
                                    interpret=True, dft_precision="highest",
                                    pupil_step_scale=1.0, **common)
        got = tk.fused_epry_chunked(*(torch.tensor(np.asarray(x))
                                      for x in (o_pl, p_pl, sup, *args)),
                                    pupil_step_scale=1.0, **common)
    (ro, rp, rm), (go, gp, gm) = (np.asarray(x) for x in ref), (x.numpy() for x in got)
    assert go.shape == ro.shape and gp.shape == rp.shape and go.dtype == np.float32
    assert rel(go, ro) < TOL_O
    assert rel(gp, rp) < TOL_P
    np.testing.assert_allclose(gm, rm, rtol=TOL_M)


def test_wrappers_refuse_other_devices():
    o = torch.zeros((2, 48, 48), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.fused_epry_sweep(o, o[:, :16, :16], o[0, :16, :16], o[:1, :16, :16],
                            torch.zeros(2, dtype=torch.int32, device="meta"),
                            np_size=16, n_large=48, delta1=5.0, delta2=10.0, eps=1e-10)


def test_cpu_route_runs_the_plain_versions_and_counts_no_launch():
    ds = synthetic_dataset(np_size=16, grid=5, seed=3)
    before = (tk.fused_epry_sweep.launches, tk.fused_epry_chunked.launches)
    got = tepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=1, use_pallas=True,
                            device="cpu")
    assert np.isfinite(got.obj_crop).all()
    assert (tk.fused_epry_sweep.launches, tk.fused_epry_chunked.launches) == before
