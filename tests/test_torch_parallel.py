"""The port's sharded sweeps (fpm_torch.parallel) on meshes of CPU ranks
against fpm_tpu's on the same mesh of virtual CPU devices, and against the
port's own single-device chunked sweep. Same inputs, made from a seed with
NumPy (the dataset of tests/test_sharding.py).

Tolerances: complex128 eager route ≤ 1e-10 relative on spectrum and pupil
(the same arithmetic in another summation order); complex64 kernel route
(the plain version of K3 here; fpm_tpu's Pallas kernel in interpret mode)
≤ 1e-5 on the spectrum, ≤ 1e-4 on the pupil, metrics rtol 1e-3 — the limits
of tests/test_sharding.py:114-117 for f32 against f32. Kernel K3 alone is
held against the Pallas kernel in tests/test_torch_kernels.py.
"""

import jax
import numpy as np
import pytest
import torch

import fpm_tpu.parallel as jpar
import fpm_tpu.parallel.comm as jcomm
from fpm_torch import parallel as tpar
from fpm_torch.models import epry as tepry
from fpm_torch.parallel import comm as tcomm
from fpm_torch.parallel import tile_shard as ttile
from fpm_tpu.data.simulate import synthetic_dataset
from fpm_tpu.models import epry as jepry
from fpm_tpu.parallel import tile_shard as jtile

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) JAX devices")


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=5)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-30)


def t_mesh(led, tile):
    return tpar.make_mesh(led=led, tile=tile, devices=["cpu"] * (led * tile))


def j_mesh(led, tile):
    return jpar.make_mesh(led=led, tile=tile, devices=jax.devices()[:led * tile])


def t_sharded(ds, led, tile, **kw):
    fn = tpar.reconstruct_led_sharded if tile == 1 else tpar.reconstruct_tile_sharded
    return fn(ds.images, ds.geom, ds.cfg, mesh=t_mesh(led, tile), **kw)


def j_sharded(ds, led, tile, **kw):
    fn = jpar.reconstruct_led_sharded if tile == 1 else jpar.reconstruct_tile_sharded
    return fn(ds.images, ds.geom, ds.cfg, mesh=j_mesh(led, tile), **kw)


# ----------------------------------------- (b) eager complex128 on meshes


@needs_8
@pytest.mark.parametrize("led,tile", [(8, 1), (1, 3), (2, 3), (1, 6), (2, 4)])
def test_sharded_eager_matches_fpm_tpu_and_single_device(ds, led, tile):
    """(1,6) and (2,4): tile height 8 and 12 below Np=16, a two-hop halo."""
    kw = dict(iterations=4, dtype="complex128", chunk_size=8)
    got = t_sharded(ds, led, tile, **kw)
    ref = j_sharded(ds, led, tile, **kw)
    single = tepry.reconstruct(ds.images, ds.geom, ds.cfg, mode="batched", device="cpu", **kw)
    for other in (ref, single):
        assert rel(got.obj_f_centered, other.obj_f_centered) < 1e-10
        assert rel(got.pupil, other.pupil) < 1e-10
        assert rel(got.obj_crop, other.obj_crop) < 1e-10
        for key in ("data_residual", "update_norm"):
            np.testing.assert_allclose(got.metrics[key], other.metrics[key], rtol=1e-9)


@needs_8
@pytest.mark.parametrize("led,tile", [(8, 1), (4, 2)])
def test_stale_consensus_matches_fpm_tpu(ds, led, tile):
    kw = dict(iterations=4, dtype="complex128", chunk_size=8, stale_consensus=True)
    got, ref = t_sharded(ds, led, tile, **kw), j_sharded(ds, led, tile, **kw)
    assert rel(got.obj_f_centered, ref.obj_f_centered) < 1e-10
    assert rel(got.pupil, ref.pupil) < 1e-10


def test_stale_consensus_is_one_trajectory_on_every_mesh_and_not_the_fresh_one(ds):
    kw = dict(iterations=4, dtype="complex128", chunk_size=8)
    a = t_sharded(ds, 8, 1, stale_consensus=True, **kw)
    for led, tile in [(2, 1), (4, 2), (1, 2), (1, 6)]:
        b = t_sharded(ds, led, tile, stale_consensus=True, **kw)
        assert rel(b.obj_f_centered, a.obj_f_centered) < 1e-10
        assert rel(b.pupil, a.pupil) < 1e-10
    fresh = t_sharded(ds, 8, 1, **kw)
    assert rel(a.obj_f_centered, fresh.obj_f_centered) > 1e-8


@pytest.mark.parametrize("led,tile", [(8, 1), (2, 2)])
def test_stale_consensus_with_one_chunk_equals_fresh(ds, led, tile):
    kw = dict(iterations=3, dtype="complex128", chunk_size=0)
    a, b = t_sharded(ds, led, tile, stale_consensus=True, **kw), t_sharded(ds, led, tile, **kw)
    assert rel(a.obj_f_centered, b.obj_f_centered) < 1e-12


def test_one_rank_whole_sweep_chunk_equals_single_device(ds):
    got = t_sharded(ds, 1, 1, iterations=3, dtype="complex128")
    ref = tepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=3, dtype="complex128",
                            mode="batched", chunk_size=0, device="cpu")
    assert rel(got.obj_f_centered, ref.obj_f_centered) < 1e-12


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 3)])
def test_initial_state_of_either_package_continues(ds, led, tile):
    """2 sweeps by fpm_tpu then 2 sharded sweeps of the port (state handed
    over as complex arrays and as planes) end where 4 sharded sweeps end."""
    kw = dict(dtype="complex128", chunk_size=8)
    full = t_sharded(ds, led, tile, iterations=4, **kw)
    half = jepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=2, mode="batched", **kw)
    state = (half.obj_f_centered, half.pupil)
    planes = tuple(np.stack([a.real, a.imag]) for a in state)
    for init in (state, planes):
        got = t_sharded(ds, led, tile, iterations=2, initial_state=init, **kw)
        assert rel(got.obj_f_centered, full.obj_f_centered) < 1e-10
        assert rel(got.pupil, full.pupil) < 1e-10


# ------------------------------------------- (c) kernel route, complex64


@needs_8
@pytest.mark.parametrize("led,tile", [(8, 1), (2, 3)])
def test_sharded_kernel_route_matches_fpm_tpu(ds, led, tile):
    kw = dict(iterations=3, dtype="complex64", chunk_size=8, use_pallas=True,
              dft_precision="highest")
    got = t_sharded(ds, led, tile, **kw)
    ref = j_sharded(ds, led, tile, **kw)
    assert rel(got.obj_f_centered, ref.obj_f_centered) < 1e-5
    assert rel(got.pupil, ref.pupil) < 1e-4
    for key in ("data_residual", "update_norm"):
        np.testing.assert_allclose(got.metrics[key], ref.metrics[key], rtol=1e-3)


@pytest.mark.parametrize("led,tile", [(8, 1), (2, 2)])
def test_bf16_comm_close_to_f32(ds, led, tile):
    kw = dict(iterations=4, dtype="complex64", chunk_size=8, use_pallas=True)
    f32 = t_sharded(ds, led, tile, **kw)
    b16 = t_sharded(ds, led, tile, comm_precision="bf16", **kw)
    assert 0 < rel(b16.obj_f_centered, f32.obj_f_centered) < 0.05


@pytest.mark.parametrize("led,tile", [(8, 1), (2, 2)])
def test_bf16_comm_refused_on_the_eager_route(ds, led, tile):
    with pytest.raises(ValueError, match="bf16"):
        t_sharded(ds, led, tile, iterations=1, dtype="complex128", comm_precision="bf16")


@pytest.mark.parametrize("led,tile,comm", [(4, 1, "f32"), (8, 1, "bf16"), (2, 2, "f32"),
                                           (2, 3, "bf16"), (1, 6, "f32")])
def test_counted_collectives_equal_the_analytic_model(ds, led, tile, comm):
    """Calls and payload bytes the mesh counted over 2 sweeps against
    led_shard_comm / tile_shard_comm; (1,6): the Np-row halo takes two hops."""
    cfg, k = ds.cfg, ds.geom.num_leds
    mesh = t_mesh(led, tile)
    fn = tpar.reconstruct_led_sharded if tile == 1 else tpar.reconstruct_tile_sharded
    fn(ds.images, ds.geom, cfg, mesh=mesh, iterations=2, chunk_size=8, use_pallas=True,
       comm_precision=comm)
    dtype_bytes = 4 if comm == "bf16" else 8
    if tile == 1:
        model = tcomm.led_shard_comm(cfg.n_large, cfg.np_size, k, 8, led, dtype_bytes)
        hops = 1
    else:
        model = tcomm.tile_shard_comm(cfg.n_large, cfg.np_size, k, led, tile, 8, dtype_bytes)
        hops = -(-cfg.np_size // (cfg.n_large // tile))
    diffs = tcomm.counted_mismatches(mesh.counts, model, sweeps=2, halo_hops=hops)
    if tile > 1 and comm == "bf16":
        # Only the reverse halo travels in bf16 (as in fpm_tpu); the model at
        # dtype_bytes=4 halves the forward halo too. Every other line is equal.
        assert len(diffs) == 1 and diffs[0].startswith("ppermute over tile")
        halo = model["collectives"][0]["payload_bytes"] * model["n_chunks_per_sweep"] * 2
        assert mesh.counts[("ppermute", "tile")]["payload_bytes"] == 2 * halo + halo
    else:
        assert diffs == []
    assert tcomm.counted_mismatches(mesh.counts, model, sweeps=3, halo_hops=hops) != []
    mesh.reset_counts()
    assert mesh.counts == {}


# ------------------------------------------------------ (d) host functions


@pytest.mark.parametrize("n_tile,n_led,chunk,assign", [
    (1, 1, 0, "strided"), (2, 1, 8, "strided"), (3, 2, 8, "strided"), (3, 2, 8, "contiguous"),
    (6, 1, 5, "strided"), (4, 2, 0, "strided")])
def test_partition_leds_by_tile_equals_fpm_tpu(ds, n_tile, n_led, chunk, assign):
    args = (ds.geom, ds.cfg.n_large, n_tile, n_led, ds.cfg.np_size, chunk, assign)
    (gi, gs), (ri, rs) = ttile.partition_leds_by_tile(*args), jtile.partition_leds_by_tile(*args)
    assert gs == rs and gi.dtype == ri.dtype
    np.testing.assert_array_equal(gi, ri)


def test_partition_leds_by_tile_value_errors(ds):
    with pytest.raises(ValueError, match="must divide"):
        ttile.partition_leds_by_tile(ds.geom, 48, 5, 1, 16)
    with pytest.raises(ValueError, match="wrap"):
        ttile.partition_leds_by_tile(ds.geom, 48, 3, 1, 40)     # Np 40 > 48 - 16


def test_mesh_shape_for_equals_fpm_tpu():
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        for n_large, np_size in ((48, 16), (360, 90), (400, 100), (64, 64)):
            assert tpar.mesh_shape_for(n, n_large, np_size) == \
                jpar.mesh_shape_for(n, n_large, np_size)


def test_effective_chunk_size_equals_fpm_tpu_below_its_ceiling():
    """Np=16: the JAX package's compile ceiling is far above these chunks."""
    for mode in ("batched", "sequential"):
        for use_pallas in (False, True):
            for chunk in (0, 1, 5, 8, 21, 30):
                for n_led in (1, 2, 3, 8):
                    args = (16, chunk, 21, use_pallas, mode)
                    assert tepry.effective_chunk_size(*args, n_led=n_led) == \
                        jepry.effective_chunk_size(*args, n_led=n_led), (args, n_led)


def test_comm_model_equals_fpm_tpu():
    for n_large, np_size, k in ((48, 16, 21), (360, 90, 193)):
        for chunk in (0, 8, 32):
            for n_led in (1, 2, 4, 8):
                for db in (4, 8):
                    assert tcomm.led_shard_comm(n_large, np_size, k, chunk, n_led, db) == \
                        jcomm.led_shard_comm(n_large, np_size, k, chunk, n_led, db)
                    for n_tile in (1, 2, 3, 6):
                        a = (n_large, np_size, k, n_led, n_tile, chunk, db)
                        got, ref = tcomm.tile_shard_comm(*a), jcomm.tile_shard_comm(*a)
                        for c in ref["collectives"]:       # the port rewords one note
                            c["what"] = c["what"].replace("next tile's top Np rows",
                                                          "the Np rows following the tile's block")
                        assert got == ref
    wire = tcomm.led_shard_comm(360, 90, 193, 32, 4)["device_wire_bytes_per_sweep"]
    for kw in (dict(), dict(overlap=0.5), dict(pipelined=True, n_chunks=7)):
        got = tcomm.project_weak_scaling(0.01, wire, 50.0, **kw)
        ref = jcomm.project_weak_scaling(0.01, wire, ici_bandwidth_gbs=50.0, **kw)
        assert got.pop("link_bandwidth_gbs") == ref.pop("ici_bandwidth_gbs") and got == ref
    with pytest.raises(TypeError):
        tcomm.project_weak_scaling(0.01, wire)      # the bandwidth has no default


def test_make_mesh_errors_and_shared_devices():
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        tpar.make_mesh(tile=16, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        tpar.make_mesh(led=0, tile=1, devices=["cpu"])
    with pytest.raises(ValueError, match="needs 6 devices; only 4 available"):
        tpar.make_mesh(led=2, tile=3, devices=["cpu"] * 4)
    mesh = tpar.make_mesh(tile=2, devices=["cpu"] * 8)
    assert mesh.shape == {"led": 4, "tile": 2} and mesh.size == 8
    assert "8 ranks on 1 device" in mesh.describe() and "share" in mesh.describe()
    assert tpar.make_mesh(led=1, tile=2, devices=["cpu"] * 8).size == 2   # extra devices unused
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpar.make_mesh(led=2, tile=1)           # the default devices are the GPUs
        with pytest.raises(RuntimeError, match="CUDA"):
            tpar.reconstruct_led_sharded(None, None, None)


def test_mesh_collectives_reduce_in_rank_order():
    mesh = t_mesh(2, 3)
    g = mesh.grid(lambda li, ti: torch.tensor([10.0 * li + ti]))
    assert [[c.item() for c in row] for row in mesh.psum(g, "led")] == [[10, 12, 14]] * 2
    assert [[c.item() for c in row] for row in mesh.psum(g, "tile")] == [[3] * 3, [33] * 3]
    assert mesh.psum(g, ("led", "tile"))[1][2].item() == 36
    assert [[c.item() for c in row] for row in mesh.pmax(g, "tile")] == [[2] * 3, [12] * 3]
    fwd = [((i + 1) % 3, i) for i in range(3)]
    assert [c.item() for c in mesh.ppermute(g, "tile", fwd)[1]] == [11, 12, 10]
    with pytest.raises(ValueError, match="permutation"):
        mesh.ppermute(g, "tile", [(0, 1), (1, 1), (2, 0)])
    with pytest.raises(ValueError, match="mesh axes"):
        mesh.psum(g, "rows")
    wide = mesh.grid(lambda li, ti: torch.tensor([1.0 + 2.0 ** -10]))
    assert mesh.psum(wide, "led", wire_dtype=torch.bfloat16)[0][0].item() == 2.0
    assert mesh.counts[("psum", "led")] == {"calls": 2, "payload_bytes": 4 + 2}
    assert mesh.counts[("ppermute", "tile")] == {"calls": 1, "payload_bytes": 4}
