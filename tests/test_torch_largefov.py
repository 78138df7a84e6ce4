"""The port's large-FOV path on the CPU against fpm_tpu's: tiling, angle
bound and stitch (NumPy, exactly equal), tile-after-tile reconstruction and
the ROI-round runner (eager complex128, ≤ 1e-10 on the stitch and every
tile; residuals rtol 1e-9), the kernels' plain versions against fpm_tpu's
Pallas kernels in interpret mode (1e-5 object, 1e-4 pupil), per-tile
persistence resuming across the two packages, and the watchdog.

The fixture is tests/test_largefov.py's: a 48-px frame of
``synthetic_dataset(np_size=48, grid=5, seed=7)`` re-cut to Np=16 ROIs
(rif 3), a 3×3 grid at overlap 4.
"""

import dataclasses
import time

import numpy as np
import pytest

from fpm_torch.config import FPMConfig as TConfig
from fpm_torch.data.simulate import synthetic_dataset as t_synthetic
from fpm_torch.geometry import compute_geometry as t_geometry
from fpm_torch.models import largefov as tl
from fpm_torch.parallel.roi_shard import make_roi_mesh as t_roi_mesh
from fpm_torch.parallel.roi_shard import reconstruct_large_fov_sharded as t_sharded
from fpm_torch.utils import checkpoint as tck
from fpm_torch.utils.watchdog import Watchdog
from fpm_tpu.data.simulate import synthetic_dataset as j_synthetic
from fpm_tpu.geometry import compute_geometry as j_geometry
from fpm_tpu.models import largefov as jl
from fpm_tpu.parallel.roi_shard import make_roi_mesh as j_roi_mesh
from fpm_tpu.parallel.roi_shard import reconstruct_large_fov_sharded as j_sharded
from fpm_tpu.utils import checkpoint as jck

TOL, TOL_O, TOL_P = 1e-10, 1e-5, 1e-4


def _cut(wide, geometry):
    cfg = dataclasses.replace(wide.cfg, np_size=16, crop_x=0, crop_y=0)
    return cfg, geometry(cfg, coordinates=wide.cfg.hole_coordinates)


@pytest.fixture(scope="module")
def wide():
    """(frames, port cfg and geometry, fpm_tpu cfg and geometry)."""
    tw, jw = t_synthetic(np_size=48, grid=5, seed=7), j_synthetic(np_size=48, grid=5, seed=7)
    assert np.array_equal(tw.images, jw.images)
    return tw.images, _cut(tw, t_geometry), _cut(jw, j_geometry)


def rel(a, b, scale):
    return np.abs(a - b).max() / scale


def assert_same_fov(got, ref, tol=TOL):
    scale = np.abs(ref.stitched).max()
    assert got.stitched.shape == ref.stitched.shape
    assert rel(got.stitched, ref.stitched, scale) <= tol
    assert len(got.tiles) == len(ref.tiles) and got.tile_origins == ref.tile_origins
    for a, b in zip(got.tiles, ref.tiles):
        assert rel(a.obj_crop, b.obj_crop, scale) <= tol
        np.testing.assert_allclose(a.metrics["data_residual"], b.metrics["data_residual"],
                                   rtol=1e-9)


@pytest.mark.parametrize("n,overlap", [(12, 4), (16, 0), (90, 22), (7, 6)])
def test_feather_weight_is_fpm_tpus(n, overlap):
    assert np.array_equal(tl._feather_weight(n, overlap), jl._feather_weight(n, overlap))


@pytest.mark.parametrize("grid,overlap", [((3, 3), 4), ((1, 2), 0), ((2, 3), 15)])
def test_roi_origins_and_angle_error_are_fpm_tpus(wide, grid, overlap):
    _, (tcfg, tgeom), (jcfg, jgeom) = wide
    assert tl.roi_origins(tcfg, grid, overlap, (48, 48)) == jl.roi_origins(
        jcfg, grid, overlap, (48, 48))
    assert tl.roi_angle_error(tcfg, tgeom, grid, overlap) == jl.roi_angle_error(
        jcfg, jgeom, grid, overlap)


def test_stitch_fields_is_fpm_tpus():
    rng = np.random.default_rng(3)
    fields = [rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30))
              for _ in range(6)]
    a, oa = tl.stitch_fields(fields, (2, 3), 30, 21, 9)
    b, ob = jl.stitch_fields(fields, (2, 3), 30, 21, 9)
    assert np.array_equal(a, b) and oa == ob


def test_grid_bounds_error_is_fpm_tpus(wide):
    images, (tcfg, tgeom), (jcfg, jgeom) = wide
    with pytest.raises(ValueError, match="tile grid") as te:
        tl.reconstruct_large_fov(images, tgeom, tcfg, grid=(9, 9), overlap=4, device="cpu")
    with pytest.raises(ValueError, match="tile grid") as je:
        jl.reconstruct_large_fov(images, jgeom, jcfg, grid=(9, 9), overlap=4)
    assert str(te.value) == str(je.value)


@pytest.fixture(scope="module")
def fpm_tpu_fov(wide):
    images, _, (jcfg, jgeom) = wide
    return jl.reconstruct_large_fov(images, jgeom, jcfg, grid=(3, 3), overlap=4, iterations=4,
                                    dtype="complex128")


def test_reconstruct_large_fov_matches_fpm_tpu(wide, fpm_tpu_fov):
    images, (tcfg, tgeom), _ = wide
    got = tl.reconstruct_large_fov(images, tgeom, tcfg, grid=(3, 3), overlap=4, iterations=4,
                                   dtype="complex128", device="cpu")
    assert_same_fov(got, fpm_tpu_fov)


def test_roi_runner_at_four_ranks_matches_fpm_tpu_and_the_sequential_run(wide, fpm_tpu_fov):
    """9 tiles on 4 CPU ranks: rounds of 4, 4 and 1 (three padding slots,
    not solved), against fpm_tpu's runner on its 8-device CPU mesh and the
    port's tile-after-tile run."""
    images, (tcfg, tgeom), (jcfg, jgeom) = wide
    kw = dict(grid=(3, 3), overlap=4, iterations=4, dtype="complex128")
    seen = []
    got = t_sharded(images, tgeom, tcfg, mesh=t_roi_mesh(["cpu"] * 4),
                    progress=lambda r, c, t: seen.append((r, c)), **kw)
    assert seen == [(r, c) for r in range(3) for c in range(3)]
    ref = j_sharded(images, jgeom, jcfg, mesh=j_roi_mesh(), **kw)
    assert_same_fov(got, ref)
    assert_same_fov(got, fpm_tpu_fov)
    seq = tl.reconstruct_large_fov(images, tgeom, tcfg, device="cpu", **kw)
    assert np.array_equal(got.stitched, seq.stitched)


@pytest.mark.parametrize("kw", [dict(), dict(mode="batched", chunk_size=8)])
def test_kernel_route_matches_fpm_tpu_pallas(wide, kw):
    """The kernels' plain versions (use_pallas on the CPU) against fpm_tpu's
    Pallas kernels in interpret mode, complex64, a 2×2 grid for 2 sweeps."""
    images, (tcfg, tgeom), (jcfg, jgeom) = wide
    common = dict(grid=(2, 2), overlap=4, iterations=2, dtype="complex64", use_pallas=True, **kw)
    common["dft_precision"] = "highest"
    got = tl.reconstruct_large_fov(images, tgeom, tcfg, device="cpu", **common)
    ref = jl.reconstruct_large_fov(images, jgeom, jcfg, **common)
    for a, b in zip(got.tiles, ref.tiles):
        assert rel(a.obj_f_centered, b.obj_f_centered, np.abs(b.obj_f_centered).max()) < TOL_O
        assert rel(a.pupil, b.pupil, np.abs(b.pupil).max()) < TOL_P


# ------------------------------------------------------------- tile store


def _store(ck, root, resume, **meta):
    return ck.TileStore(str(root), meta={"grid": "2x2", **meta}, resume=resume)


@pytest.mark.parametrize("first,second", [(jl, tl), (tl, jl)])
def test_tiles_resume_across_packages(wide, tmp_path, first, second):
    """Tiles written by one package's runner are loaded, not solved, by the
    other's; the stitch is then bitwise the writer's."""
    images, tset, jset = wide
    sets = {tl: (tset, tck, {"device": "cpu"}), jl: (jset, jck, {})}
    (cfg1, geom1), ck1, extra1 = sets[first]
    (cfg2, geom2), ck2, extra2 = sets[second]
    kw = dict(grid=(2, 2), overlap=4, iterations=3, dtype="complex128")
    full = first.reconstruct_large_fov(images, geom1, cfg1,
                                       tile_store=_store(ck1, tmp_path, False), **kw, **extra1)
    solved = []
    again = second.reconstruct_large_fov(images, geom2, cfg2,
                                         tile_store=_store(ck2, tmp_path, True),
                                         progress=lambda r, c, t: solved.append((r, c)),
                                         **kw, **extra2)
    assert solved == []
    assert np.array_equal(again.stitched, full.stitched)


@pytest.mark.parametrize("writer", [tck, jck])
def test_a_tile_of_another_configuration_is_refused_alike(tmp_path, writer):
    planes = np.zeros((2, 4, 4))
    writer.TileStore(str(tmp_path), meta={"iterations": 5}).put(0, planes, planes, planes,
                                                                np.zeros((5, 2)))
    errors = []
    for ck in (tck, jck):
        with pytest.raises(ValueError) as e:
            ck.TileStore(str(tmp_path), meta={"iterations": 6}, resume=True).get(0)
        assert type(e.value).__name__ == "CheckpointMismatch"
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "iterations: saved=5 vs now=6" in errors[0]


def test_a_round_over_two_devices_solves_them_at_once(wide, fpm_tpu_fov):
    """Ranks on two devices (``cpu`` and ``cpu:0`` are two to torch): each
    round's tiles of a device go to it in one call, the devices in threads;
    the result is the one-device run's."""
    images, (tcfg, tgeom), _ = wide
    got = t_sharded(images, tgeom, tcfg, mesh=t_roi_mesh(["cpu", "cpu:0"] * 2), grid=(3, 3),
                    overlap=4, iterations=4, dtype="complex128")
    assert_same_fov(got, fpm_tpu_fov)


def test_resume_with_tiles_deleted_gives_the_same_stitch(wide, tmp_path):
    images, (tcfg, tgeom), _ = wide
    kw = dict(grid=(3, 3), overlap=4, iterations=3, dtype="complex128",
              mesh=t_roi_mesh(["cpu"] * 4))
    first = t_sharded(images, tgeom, tcfg, tile_store=_store(tck, tmp_path, False), **kw)
    for i in (0, 4, 8):
        (tmp_path / f"tile_{i:04d}.npz").unlink()
    solved = []
    again = t_sharded(images, tgeom, tcfg, tile_store=_store(tck, tmp_path, True),
                      progress=lambda r, c, t: solved.append((r, c)), **kw)
    assert solved == [(0, 0), (1, 1), (2, 2)]
    assert np.array_equal(again.stitched, first.stitched)


def test_a_store_that_does_not_write_stores_nothing(tmp_path):
    store = tck.TileStore(str(tmp_path / "t"), meta={}, write=False)
    store.put(0, *(np.zeros((2, 2, 2)),) * 3, np.zeros((1, 2)))
    assert not (tmp_path / "t").exists()


def test_roi_mesh_of_explicit_devices():
    mesh = t_roi_mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and "3 ROI ranks on 1 device" in mesh.describe()
    with pytest.raises(ValueError, match="at least one rank"):
        t_roi_mesh([])


def test_roi_mesh_without_a_gpu_is_an_error():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_roi_mesh()


def test_the_configs_agree(wide):
    """The two re-cut configurations are one problem (a guard on the
    comparisons above)."""
    _, (tcfg, tgeom), (jcfg, jgeom) = wide
    assert isinstance(tcfg, TConfig)
    assert tcfg.n_large == jcfg.n_large
    assert tcfg.res_improvement_factor == jcfg.res_improvement_factor
    assert np.array_equal(tgeom.crop_start, jgeom.crop_start)


# --------------------------------------------------------------- watchdog
# tests/test_faults.py's three cases, on the port's copy.


def test_watchdog_fires_on_stall():
    fired = []
    wd = Watchdog(timeout=0.2, on_timeout=lambda: fired.append(1), poll_interval=0.05).start()
    try:
        deadline = time.time() + 5
        while not fired and time.time() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert fired


def test_watchdog_beats_prevent_firing():
    fired = []
    with Watchdog(timeout=0.4, on_timeout=lambda: fired.append(1), poll_interval=0.05) as wd:
        for _ in range(10):
            wd.beat()
            time.sleep(0.1)
    assert not fired


def test_watchdog_rejects_bad_timeout():
    with pytest.raises(ValueError):
        Watchdog(timeout=0)
