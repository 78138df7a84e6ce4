"""The port's eager solver against fpm_tpu's reconstruct and the NumPy
oracle, with the tolerances of tests/test_solver_parity.py: complex128
≤ 1e-10 against fpm_tpu in both sweep modes (object spectrum, pupil,
object, metrics), ≤ 1e-12 against the oracle, complex64 ≤ 1e-3 against the
oracle; plus state carried between the packages in both directions."""

import numpy as np
import pytest
import torch

from fpm_torch.models import epry as tepry
from fpm_tpu.data.simulate import synthetic_dataset
from fpm_tpu.models.epry import _planes, reconstruct as jreconstruct
from fpm_tpu.oracle import run_fpm_oracle


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=1)


def treconstruct(ds, **kw):
    return tepry.reconstruct(ds.images, ds.geom, ds.cfg, device="cpu", **kw)


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(global_max="lazy"),
    dict(mode="batched", chunk_size=8),
    dict(mode="batched", chunk_size=7, chunk_assign="contiguous", pupil_step_scale=0.5),
    dict(mode="batched", chunk_size=0),
])
def test_eager_matches_fpm_tpu_complex128(ds, kw):
    ref = jreconstruct(ds.images, ds.geom, ds.cfg, iterations=3, dtype="complex128", **kw)
    got = treconstruct(ds, iterations=3, dtype="complex128", **kw)
    assert got.obj_f_centered.dtype == np.complex128
    assert rel(got.obj_f_centered, ref.obj_f_centered) <= 1e-10
    assert rel(got.pupil, ref.pupil) <= 1e-10
    assert rel(got.obj_crop, ref.obj_crop) <= 1e-10
    for key in ("data_residual", "update_norm"):
        assert got.metrics[key].shape == (3,)
        np.testing.assert_allclose(got.metrics[key], ref.metrics[key], rtol=1e-10)


def test_eager_matches_oracle(ds):
    ora = run_fpm_oracle(ds.images, ds.geom, ds.cfg, iterations=3)
    got = treconstruct(ds, iterations=3, dtype="complex128")
    assert np.abs(got.obj_f - ora.obj_f).max() / np.abs(ora.obj_f).max() < 1e-12
    assert np.abs(got.pupil - ora.pupil).max() < 1e-12
    assert rel(got.obj_crop, ora.obj_crop) < 1e-12


def test_complex64_close_to_oracle(ds):
    ora = run_fpm_oracle(ds.images, ds.geom, ds.cfg, iterations=3)
    got = treconstruct(ds, iterations=3, dtype="complex64")
    assert got.obj_f_centered.dtype == np.complex64
    assert rel(got.obj_f, ora.obj_f) < 1e-3


def test_seed_is_second_lowest_na_and_zero_iterations(ds):
    images = ds.images.copy()
    images[ds.geom.schedule[1]] = 0
    res = treconstruct(ds, iterations=0, dtype="complex128")
    assert np.abs(res.obj_f_centered).max() > 0
    zero = tepry.reconstruct(images, ds.geom, ds.cfg, iterations=0, dtype="complex128",
                             device="cpu")
    assert np.abs(zero.obj_f_centered).max() == 0.0
    assert zero.metrics["data_residual"].shape == (0,)


@pytest.mark.parametrize("kw", [dict(), dict(mode="batched", chunk_size=8)])
def test_state_carries_between_packages(ds, kw):
    """2 sweeps in one package, then 2 more from that state in the other,
    equal 4 sweeps in one run (complex128, ≤ 1e-10), both directions; the
    state goes across as complex arrays and as (2, ...) planes."""
    full = jreconstruct(ds.images, ds.geom, ds.cfg, iterations=4, dtype="complex128", **kw)

    half_j = jreconstruct(ds.images, ds.geom, ds.cfg, iterations=2, dtype="complex128", **kw)
    o_pl, p_pl = np.asarray(_planes(half_j.obj_f_centered)), np.asarray(_planes(half_j.pupil))
    for state in ((half_j.obj_f_centered, half_j.pupil), (o_pl, p_pl)):
        cont = treconstruct(ds, iterations=2, dtype="complex128", initial_state=state, **kw)
        assert rel(cont.obj_f_centered, full.obj_f_centered) <= 1e-10
        assert rel(cont.pupil, full.pupil) <= 1e-10

    half_t = treconstruct(ds, iterations=2, dtype="complex128", **kw)
    o_t, p_t = tepry.state_from_numpy(half_t.obj_f_centered, half_t.pupil, device="cpu",
                                      dtype=torch.complex128)
    cont = jreconstruct(ds.images, ds.geom, ds.cfg, iterations=2, dtype="complex128",
                        initial_state=tepry.state_to_numpy(o_t, p_t), **kw)
    assert rel(cont.obj_f_centered, full.obj_f_centered) <= 1e-10
    assert rel(cont.pupil, full.pupil) <= 1e-10


def test_state_round_trip_as_planes():
    o = np.arange(8.0).reshape(2, 2, 2)
    p = np.ones((3, 3), np.complex64) * (1 - 2j)
    ot, pt = tepry.state_from_numpy(o, p, device="cpu", dtype="complex128")
    assert ot.dtype == torch.complex128 and ot.shape == (2, 2)
    np.testing.assert_array_equal(ot.numpy(), o[0] + 1j * o[1])
    planes = tepry.state_to_numpy(ot, pt, planes=True)
    np.testing.assert_array_equal(planes[0], o)
    np.testing.assert_array_equal(planes[1][1], -2 * np.ones((3, 3)))


def test_effective_chunk_size():
    assert tepry.effective_chunk_size(90, 32, 193, True, "batched") == 32
    assert tepry.effective_chunk_size(90, 0, 193, True, "batched") == 193
    assert tepry.effective_chunk_size(16, 999, 25, True, "batched") == 25
    assert tepry.effective_chunk_size(16, 999, 25, False, "batched") == 999
    assert tepry.effective_chunk_size(16, 0, 25, False, "batched") == 0
    assert tepry.effective_chunk_size(200, 32, 88, True, "sequential") == 32


def test_options_refuse_unported_and_bad_values(ds):
    with pytest.raises(ValueError, match="not yet ported"):
        tepry.EPRYOptions.from_config(ds.cfg, dft_precision="bf16x3")
    with pytest.raises(ValueError):
        tepry.EPRYOptions.from_config(ds.cfg, mode="jacobi")
    with pytest.raises(ValueError):
        tepry.EPRYOptions.from_config(ds.cfg, dtype="float32")


def test_cuda_entry_point_never_runs_on_the_cpu(ds):
    """The default device is cuda: without a GPU it raises; with one, the
    eager route is refused (the card sweeps only through the kernels)."""
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="use_pallas"):
            tepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=1)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=1, use_pallas=True)
