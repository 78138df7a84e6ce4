"""The plain PyTorch versions of kernels K1, K2 and K3 (float32, on the CPU)
against fpm_tpu's Pallas kernels run in interpret mode, with the cases and
tolerances of tests/test_pallas.py: rel-max 1e-5 on the object spectrum,
1e-4 on the pupil, metrics rtol 1e-4 (f32 against f32: the two differ in
summation order only); K3, which the JAX package tests only through its
sharded sweeps, at their limits (tests/test_sharding.py:114-117: 1e-5, 1e-4,
metrics rtol 1e-3). The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpm_torch.data.simulate import synthetic_dataset as t_synthetic
from fpm_torch.geometry import pupil_radius as t_pupil_radius
from fpm_torch.models import epry as tepry
from fpm_torch.ops import kernels as tk
from fpm_torch.parallel.tile_shard import partition_leds_by_tile
from fpm_tpu.data.simulate import synthetic_dataset
from fpm_tpu.geometry import pupil_support
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
                            dtype="complex64", use_pallas=True, dft_precision="highest",
                            device="cpu", **kw)
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
                                    for a in (o_pl, p_pl, sup, *args)),
                                  dft_precision="highest", **common)
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
                                    pupil_step_scale=1.0, dft_precision="highest", **common)
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


# ------------------------------------------------------------------ K3 alone


def _k3_operands(ds, block):
    """One chunk's operands from a state that is not the init (a spectrum
    after one sweep, a pupil with phase). ``block='square'``: the whole
    spectrum and one chunk of the chunk-8 schedule (one masked dummy);
    ``'tile'``: tile 1 of 3 extended by its halo (rows 16..47: 32×48), that
    tile's workset of chunk 0 (one -1 slot, masked), block-relative starts."""
    cfg, n, nl = ds.cfg, ds.cfg.np_size, ds.cfg.n_large
    start = jreconstruct(ds.images, ds.geom, cfg, iterations=1, dtype="complex64")
    rng = np.random.default_rng(0)
    pupil = start.pupil * np.exp(0.3j * rng.standard_normal(start.pupil.shape))
    o_pl, p_pl = _planes_np(start.obj_f_centered), _planes_np(pupil)
    sup = pupil_support(cfg).astype(np.float32)
    order = ds.geom.schedule
    amps_all = np.sqrt(np.asarray(ds.images, np.float64))[order].astype(np.float32)
    starts_all = ds.geom.crop_start[order].astype(np.int32)
    k = len(order)
    if block == "square":
        perm, mask, n_chunks = tepry.chunk_schedule(k, 8, "strided")
        sel = perm.reshape(n_chunks, 8)[1]
        valid = (sel < k).astype(np.int32)
        sel = np.where(sel < k, sel, 0)
        starts = starts_all[sel] * valid[:, None]
    else:
        idx, s = partition_leds_by_tile(ds.geom, nl, 3, 1, n, chunk_size=8)
        sel = idx[0, 0, 1]
        valid = (sel >= 0).astype(np.int32)
        sel = np.where(sel >= 0, sel, 0)
        starts = (starts_all[sel] - np.array([s, 0], np.int32)) * valid[:, None]
        o_pl = o_pl[:, s:2 * s + n]
        assert o_pl.shape == (2, 32, 48) and 1 < valid.sum() < valid.size
        assert starts[:, 0].max() + n > s               # a patch reaches into the halo
    amps = (amps_all[sel] * valid[:, None, None]).astype(np.float32)
    return (o_pl, p_pl, sup, amps, starts.reshape(-1).astype(np.int32), valid), dict(
        np_size=n, n_rows=o_pl.shape[1], n_cols=o_pl.shape[2], delta1=cfg.delta1,
        delta2=cfg.delta2, eps=cfg.eps, pupil_radius=EPRYOptions.from_config(
            cfg).pupil_radius)


@pytest.mark.parametrize("block", ["square", "tile"])
@pytest.mark.parametrize("collect_metrics", [True, False])
def test_k3_plain_matches_pallas(block, collect_metrics):
    """fused_chunk_increments_plain against fpm_tpu's fused_chunk_increments
    (interpret mode) called directly on identical planes."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=5, aberrated_pupil=True)
    args, kw = _k3_operands(ds, block)
    rd, rv, rm = (np.asarray(x) for x in jk.fused_chunk_increments(
        *(jnp.asarray(a) for a in args), interpret=True, dft_precision="highest",
        collect_metrics=collect_metrics, **kw))
    for fn in (tk.fused_chunk_increments_plain, tk.fused_chunk_increments):   # CPU: both plain
        gd, gv, gm = (x.numpy() for x in fn(*(torch.tensor(a) for a in args),
                                            collect_metrics=collect_metrics,
                                            dft_precision="highest", **kw))
        assert gd.shape == rd.shape and gv.shape == rv.shape and gd.dtype == np.float32
        assert rel(gd, rd) < 1e-5
        assert rel(gv, rv) < 1e-4
        if collect_metrics:
            np.testing.assert_allclose(gm, rm, rtol=1e-3)
        else:
            assert (gm == 0).all() and (rm == 0).all()
        assert np.abs(gv[:, pupil_support(ds.cfg) == 0]).max() == 0.0


def test_k3_masked_slots_add_nothing_and_d_is_zero_outside_the_windows():
    ds = synthetic_dataset(np_size=16, grid=5, seed=5, aberrated_pupil=True)
    args, kw = _k3_operands(ds, "tile")
    o, p, sup, amps, starts, valid = (torch.tensor(a) for a in args)
    d, v, m = tk.fused_chunk_increments(o, p, sup, amps, starts, valid, **kw)
    live = valid > 0
    junk_amps = amps.clone()
    junk_amps[~live] = 7.0                       # a masked slot's frame is never read
    d2, v2, m2 = tk.fused_chunk_increments(
        o, p, sup, junk_amps, starts, valid, **kw)
    assert torch.equal(d, d2) and torch.equal(v, v2) and torch.equal(m, m2)
    d3, v3, m3 = tk.fused_chunk_increments(
        o, p, sup, amps[live], starts.view(-1, 2)[live].reshape(-1), valid[live], **kw)
    assert torch.equal(d, d3) and torch.equal(v, v3) and torch.equal(m, m3)
    covered = torch.zeros(d.shape[1:], dtype=torch.bool)
    b, lo = tk.bbox_extent(kw["np_size"], kw["pupil_radius"])
    for y, x in starts.view(-1, 2)[live].tolist():
        covered[y + lo:y + lo + b, x + lo:x + lo + b] = True
    assert d[:, ~covered].abs().max() == 0 and d[:, covered].abs().max() > 0
    before = tk.fused_chunk_increments.launches
    with pytest.raises(ValueError, match="n_rows"):
        tk.fused_chunk_increments(o, p, sup, amps, starts, valid, **dict(kw, n_rows=48))
    with pytest.raises(ValueError, match="no kernel"):
        tk.fused_chunk_increments(o.to("meta"), p, sup, amps, starts, valid, **kw)
    assert tk.fused_chunk_increments.launches == before    # the CPU route counts no launch


# ------------------------------------------- the cluster's slab decomposition


@pytest.mark.parametrize("rows", [16, 48, 64, 90, 100])
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_slabs_cover_every_row_once(cs, rows):
    """The rule by which a cluster of ``cs`` blocks cuts ``rows`` rows (of
    the image plane or of the bbox) into slabs: ragged and empty slabs
    included (90 rows on 8 blocks: 7 slabs of 12 and one of 6; 90 on 16: 15
    of 6 and an empty one). That the kernels compute the right function on
    such slabs is held on the card (tests/test_torch_cuda.py, forced cluster
    sizes)."""
    bounds = tk.slab_bounds(rows, cs)
    assert len(bounds) == cs and bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(0 <= r1 - r0 <= -(-rows // cs) for r0, r1 in bounds)
    assert sorted(r for r0, r1 in bounds for r in range(r0, r1)) == list(range(rows))


# ---------------------------------------------- problem axis, plain versions
# K1 and K2 with a leading problem axis: the plain versions run the problems
# one after another, bitwise the single-problem calls (the CUDA kernels are
# held to the same on the card, tests/test_torch_cuda.py).


def _problem_operands(mode, n_prob=3):
    ds = t_synthetic(np_size=16, grid=5, seed=3)
    opts = tepry.EPRYOptions.from_config(ds.cfg, use_pallas=True, mode=mode, chunk_size=7)
    sup = torch.as_tensor(tepry.pupil_support(ds.cfg, centered=False), dtype=torch.float32)
    per = []
    for q in range(n_prob):
        amps, starts = tepry._sorted_device_inputs(ds.images * (1 + 0.1 * q), ds.geom,
                                                   torch.complex64, "cpu")
        o, p = tepry.init_traced(amps, sup, opts)
        if mode == "batched":
            amps, starts_it, mask = tepry._chunk_inputs(amps, starts, opts, torch.float32)
            shared = (starts_it.reshape(-1), (mask > 0).reshape(-1).to(torch.int32))
        else:
            shared = (starts.reshape(-1),)
        per.append((torch.stack([o.real, o.imag]), torch.stack([p.real, p.imag]), amps))
    common = dict(np_size=16, n_large=ds.cfg.n_large, delta1=ds.cfg.delta1,
                  delta2=ds.cfg.delta2, eps=ds.cfg.eps, pupil_radius=opts.pupil_radius,
                  collect_metrics=True)
    return per, sup, shared, common


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_plain_problem_axis_is_bitwise_three_single_calls(mode):
    per, sup, shared, common = _problem_operands(mode)
    fn = tk.fused_epry_sweep if mode == "sequential" else tk.fused_epry_chunked
    o_b, p_b, a_b = (torch.stack(x) for x in zip(*per))
    o, p, m = fn(o_b, p_b, sup, a_b, *shared, **common)
    assert o.shape[0] == p.shape[0] == m.shape[0] == 3
    for q, (oq, pq, aq) in enumerate(per):
        so, sp, sm = fn(oq, pq, sup, aq, *shared, **common)
        assert torch.equal(o[q], so) and torch.equal(p[q], sp) and torch.equal(m[q], sm)


def test_problem_axis_shapes_must_agree():
    per, sup, shared, common = _problem_operands("sequential", 2)
    o, p, a = (torch.stack(x) for x in zip(*per))
    with pytest.raises(ValueError, match="problem axis"):
        tk._check_problem_axis(o, p[:1], a, sc=sup, starts=shared[0], n_slots=a.shape[1])


def test_plain_square_root_is_correctly_rounded():
    """The plain versions' float32 square root gives NumPy's (and CUDA's)
    correctly rounded value on every element, call after call: the plain
    versions once took torch's float32 square root on the CPU, which is not
    correctly rounded here and whose first call in a process made a
    two-process mesh differ from the one-process mesh (ROADMAP §3, F4)."""
    x = (np.random.default_rng(0).random(4864) * 1e4 + 1).astype(np.float32)
    want = np.sqrt(x)
    for _ in range(3):
        got = tk._sqrt(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
