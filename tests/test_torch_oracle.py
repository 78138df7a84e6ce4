"""The port's NumPy oracle and judge metric against fpm_tpu's: the oracle
(``fpm_torch.oracle.run_fpm_oracle``) gives fpm_tpu's bits, at two sizes
and after 0 and 3 sweeps; ``complex_field_rmse`` gives fpm_tpu's float;
and the port's eager sequential solve lies within 1e-12 of the port's own
oracle in complex128 — the contract checkable without JAX."""

import numpy as np
import pytest

from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.models import epry as tepry
from fpm_torch.oracle import run_fpm_oracle
from fpm_torch.utils.metrics import complex_field_rmse
from fpm_tpu.oracle import run_fpm_oracle as jrun_fpm_oracle
from fpm_tpu.utils.metrics import complex_field_rmse as jcomplex_field_rmse

SIZES = [(16, 5), (32, 7)]


@pytest.fixture(scope="module", params=SIZES, ids=lambda p: f"np{p[0]}-grid{p[1]}")
def ds(request):
    np_size, grid = request.param
    return synthetic_dataset(np_size=np_size, grid=grid, seed=3)


@pytest.mark.parametrize("iterations", [0, 3])
def test_oracle_is_bitwise_fpm_tpus(ds, iterations):
    got = run_fpm_oracle(ds.images, ds.geom, ds.cfg, iterations=iterations)
    ref = jrun_fpm_oracle(ds.images, ds.geom, ds.cfg, iterations=iterations)
    for name in ("obj_crop", "obj_f", "pupil", "pupil_support"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_eager_sequential_solve_within_1e_12_of_the_ports_oracle(ds):
    ora = run_fpm_oracle(ds.images, ds.geom, ds.cfg, iterations=3)
    got = tepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=3, dtype="complex128",
                            device="cpu")
    assert np.abs(got.obj_f - ora.obj_f).max() / np.abs(ora.obj_f).max() < 1e-12
    assert np.abs(got.pupil - ora.pupil).max() < 1e-12
    assert complex_field_rmse(got.obj_crop, ora.obj_crop) < 1e-12


@pytest.mark.parametrize("align_scale", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_complex_field_rmse_is_fpm_tpus_float(seed, align_scale):
    rng = np.random.default_rng(seed)
    shape = (24, 24)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    # a: b at another complex scale, plus noise (the case the alignment is for)
    a = (0.7 - 0.4j) * b + 0.05 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    for x, y in ((a, b), (b, a), (a.astype(np.complex64), b), (np.zeros(shape), b)):
        got = complex_field_rmse(x, y, align_scale=align_scale)
        assert isinstance(got, float)
        assert got == jcomplex_field_rmse(x, y, align_scale=align_scale)
