"""The CUDA kernels K1, K2 and K3 against their plain PyTorch versions, a
sharded sweep (K3) against the single-device one (K1), K1 and K2 with a
problem axis against solo launches (bitwise, at forced cluster sizes, with a
NaN problem), and the --fov-grid and --color-mode rgb runs per tile and per
channel against solo solves, on the card. They skip without a CUDA device
(one case needs two). This file imports neither JAX nor fpm_tpu, so it also
runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Tolerances: rel-max 1e-5 on the object spectrum, 1e-4 on the pupil,
metrics rtol 1e-4 — float32 against float32, differing only in summation
order — at either precision tier of the DFT products (the ``tier``
fixture: bf16x3 on the tensor cores, the default, and highest in FP32; the
bf16x3 kernel against the bf16x3 plain version, which forms the same exact
bf16 products; K3's d at bf16x3 as k3_d_limit says). The kernels run one
LED on a thread-block cluster (compute capability 9.0); the cases with a forced cluster size hold the one-block
path (1) and the distributed-shared-memory path (2, 4, 8) whatever size
the entry points would choose.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.geometry import pupil_support
from fpm_torch.models import epry
from fpm_torch.ops import kernels
from fpm_torch.parallel import make_mesh, reconstruct_led_sharded, reconstruct_tile_sharded
from fpm_torch.parallel.tile_shard import partition_leds_by_tile

TOL_O, TOL_P, TOL_M = 1e-5, 1e-4, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is compared with its plain version there")
    return torch.device("cuda")


@pytest.fixture(params=["bf16x3", "highest"])
def tier(request):
    """The precision tier of the DFT products (``dft_precision``)."""
    return request.param


@pytest.fixture
def force_cluster():
    """Sets a wrapper's test-only cluster size, and takes it back."""
    touched = []

    def force(wrapper, cs):
        touched.append(wrapper)
        wrapper.force_cluster_size = cs

    yield force
    for wrapper in touched:
        wrapper.force_cluster_size = 0


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def operands(ds, dev, mode, chunk=0, tier="bf16x3"):
    """Init-state planes and the sweep operands of one wrapper call at the
    precision ``tier``."""
    opts = epry.EPRYOptions.from_config(ds.cfg, use_pallas=True, mode=mode, chunk_size=chunk)
    amps, starts = epry._sorted_device_inputs(ds.images, ds.geom, torch.complex64, dev)
    sup = torch.as_tensor(pupil_support(ds.cfg), dtype=torch.float32, device=dev)
    o, p = epry.init_traced(amps, sup, opts)
    planes = (torch.stack([o.real, o.imag]).contiguous(),
              torch.stack([p.real, p.imag]).contiguous(), sup)
    common = dict(np_size=ds.cfg.np_size, n_large=ds.cfg.n_large, delta1=ds.cfg.delta1,
                  delta2=ds.cfg.delta2, eps=ds.cfg.eps, pupil_radius=opts.pupil_radius,
                  collect_metrics=True, dft_precision=tier)
    if mode == "sequential":
        return planes, (amps, starts.reshape(-1)), common
    amps_it, starts_it, mask = epry._chunk_inputs(amps, starts, opts, torch.float32)
    return planes, (amps_it, starts_it.reshape(-1), (mask > 0).reshape(-1).to(torch.int32)), \
        dict(common, pupil_step_scale=1.0)


def two_sweeps(fn, planes, rest, common, **kw):
    o, p, sup = planes
    mets = []
    for _ in range(2):
        o, p, m = fn(o, p, sup, *rest, **common, **kw)
        mets.append(m)
    return o, p, torch.stack(mets)


def assert_kernel_matches_plain(kernel, plain, planes, rest, common, **kw):
    ko, kp, km = two_sweeps(kernel, planes, rest, common, **kw)
    torch.cuda.synchronize()
    po, pp, pm = two_sweeps(plain, planes, rest, common, **kw)
    assert rel(ko, po) < TOL_O
    assert rel(kp, pp) < TOL_P
    np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), rtol=TOL_M)
    return kp


@pytest.mark.parametrize("np_size,global_max", [(16, "exact"), (16, "lazy"), (64, "exact"),
                                               (100, "exact")])
def test_k2_matches_plain(cuda, tier, np_size, global_max):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "sequential", tier=tier)
    before = kernels.fused_epry_sweep.launches
    kp = assert_kernel_matches_plain(kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                                     planes, rest, common, global_max=global_max)
    assert kernels.fused_epry_sweep.launches == before + 2 * 2    # row-max init + the sweep
    assert kernels.fused_epry_sweep.cluster_size in (1, 2, 4, 8)
    outside = torch.as_tensor(pupil_support(ds.cfg), device=cuda) == 0
    assert kp[:, outside].abs().max().item() == 0.0


@pytest.mark.parametrize("np_size,chunk", [(16, 7), (16, 0), (64, 6), (100, 8)])
def test_k1_matches_plain(cuda, tier, np_size, chunk):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "batched", chunk, tier)
    before = kernels.fused_epry_chunked.launches
    assert_kernel_matches_plain(kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain,
                                planes, rest, common)
    n_chunks = rest[0].shape[0]
    assert kernels.fused_epry_chunked.launches == before + 2 * 3 * n_chunks


@pytest.mark.parametrize("np_size", [16, 64, 90, 100])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_k2_matches_plain_at_a_forced_cluster_size(cuda, tier, force_cluster, np_size, cs):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "sequential", tier=tier)
    force_cluster(kernels.fused_epry_sweep, cs)
    assert_kernel_matches_plain(kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                                planes, rest, common)
    assert kernels.fused_epry_sweep.cluster_size == cs


@pytest.mark.parametrize("np_size", [16, 64, 90, 100])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_k1_matches_plain_at_a_forced_cluster_size(cuda, tier, force_cluster, np_size, cs):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "batched", 7, tier)
    force_cluster(kernels.fused_epry_chunked, cs)
    assert_kernel_matches_plain(kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain,
                                planes, rest, common)
    assert kernels.fused_epry_chunked.cluster_size == cs


@pytest.mark.parametrize("kernel,mode,chunk", [("K2", "sequential", 0), ("K1", "batched", 7)])
def test_a_repeated_sweep_is_bitwise_equal(cuda, tier, kernel, mode, chunk):
    """Every sum has one fixed order (each element of each product is one
    thread's, or one tensor-core tile's, sum over the whole contraction in
    index order, whatever the cluster size; the chunk's increments are added
    in LED order)."""
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, mode, chunk, tier)
    fn = kernels.fused_epry_sweep if kernel == "K2" else kernels.fused_epry_chunked
    first = two_sweeps(fn, planes, rest, common)
    again = two_sweeps(fn, planes, rest, common)
    assert fn.cluster_size > 1
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# ablate= on the card: each variant against the plain version with the same
# ablate, one sweep, at the kernels' limits where the variant forms the
# products as the kernel does or forms none; dft-1pass (8 bits of each
# operand: a last-bit difference between two summation orders can flip a
# bf16 rounding) at 1e-4 / 2^-9 / 1e-4 (chip_smoke.py ABLATE_TOL).
ABLATE_TOL = {"dft-1pass": (1e-4, 2.0 ** -9, 1e-4)}


def ablation_inputs(args, ablate, b):
    """The state a variant runs from: divided by max|O| for omax-const (its
    max|O| is 1 + k), with values at the spectrum's corner for
    no-window-read (0 after the init), else ``args``."""
    o = args[0]
    if ablate == "omax-const":
        scale = (o[0] ** 2 + o[1] ** 2).max().rsqrt()
        return (o * scale, *args[1:3], args[3] * scale, *args[4:])
    if ablate == "no-window-read":
        corner = o.clone()
        corner[:, :b, :b] += 0.01 * o.abs().max() * torch.randn(
            (2, b, b), generator=torch.Generator().manual_seed(0)).to(o.device)
        return (corner, *args[1:])
    return args


def ablation_names(kernel, tier):
    names = kernels.SWEEP_ABLATIONS if kernel == "K2" else kernels.CHUNKED_ABLATIONS
    return [a for a in names if a != "dft-1pass" or tier == "bf16x3"]


@pytest.mark.parametrize("kernel,mode,chunk", [("K2", "sequential", 0), ("K1", "batched", 6)])
def test_ablated_kernels_match_their_plain_versions(cuda, tier, kernel, mode, chunk):
    """Np 64 (bbox 48 at offset 8). omax-const runs from the state divided by
    max|O| (its max|O| is 1 + k), no-window-read with values at the
    spectrum's corner (0 after the init); ``ablate=""`` through the ablation
    build is bitwise the kernel."""
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    (o, p, sup), rest, common = operands(ds, cuda, mode, chunk, tier)
    fn, plain, names = ((kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                         kernels.SWEEP_ABLATIONS) if kernel == "K2" else
                        (kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain,
                         kernels.CHUNKED_ABLATIONS))
    b, _ = kernels.bbox_extent(64, common["pupil_radius"])
    for ablate in names:
        state, _, _, *args = ablation_inputs((o, p, sup, *rest), ablate, b)
        got = fn(state, p, sup, *args, **common, ablate=ablate)
        want = plain(state, p, sup, *args, **common, ablate=ablate)
        tol_o, tol_p, tol_m = ABLATE_TOL.get(ablate, (TOL_O, TOL_P, TOL_M))
        assert rel(got[0], want[0]) < tol_o, ablate
        assert rel(got[1], want[1]) < tol_p, ablate
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=tol_m)
        if not ablate:
            fn.force_ablation_build = True
            try:
                again = fn(state, p, sup, *args, **common)
            finally:
                fn.force_ablation_build = False
            for a, b_ in zip(got, again):
                assert torch.equal(a, b_)


def test_ablation_builds_leave_the_main_libraries_alone(cuda):
    """The ablation kernels live in builds of their own (``-DFPM_ABLATE``):
    the main libraries hold none, their flags are the main build's."""
    from fpm_torch.ops import build

    main, ablation = build.build_with_ablations()
    assert set(ablation) == set(build.ABLATION_STEMS)
    for stem in build.ABLATION_STEMS:
        assert main[stem] != ablation[stem]
        assert not any("ablate" in name for name in build.resources(stem))
        assert any("ablate" in name for name in build.resources(stem, ablate=True))
    with pytest.raises(ValueError, match="no ablation build"):
        build.ablation_library("epry_increments")


def test_k2_profile_build_counts_every_phase_and_changes_no_result(cuda):
    """The cycle-counting build of K2 (a measurement aid the wrapper never
    loads) computes the same sweep, bit for bit, and every phase of an LED
    gets cycles, anew in each run."""
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    (o, p, sup), rest, common = operands(ds, cuda, "sequential")
    plain_build = kernels.fused_epry_sweep(o, p, sup, *rest, **common)
    _, first = kernels.k2_phase_profile(o, p, sup, *rest, **common)
    profiled, cycles = kernels.k2_phase_profile(o, p, sup, *rest, **common)
    for a, b in zip(plain_build, profiled):
        assert torch.equal(a, b)
    assert len(cycles) == 18 and all(c > 0 for c in cycles.values())
    assert list(cycles) == list(first) and sum(cycles.values()) < 2 * sum(first.values())


def test_k2_profile_build_runs_the_bf16x3_tier_bitwise(cuda):
    ds = synthetic_dataset(np_size=90, grid=5, seed=3)
    (o, p, sup), rest, common = operands(ds, cuda, "sequential")
    assert common["dft_precision"] == "bf16x3"
    plain_build = kernels.fused_epry_sweep(o, p, sup, *rest, **common)
    profiled, cycles = kernels.k2_phase_profile(o, p, sup, *rest, **common)
    for a, b in zip(plain_build, profiled):
        assert torch.equal(a, b)
    assert all(c > 0 for c in cycles.values())


@pytest.mark.parametrize("np_size", [16, 64, 90])
def test_bf16x3_k2_is_near_highest_where_one_pass_is_not(cuda, np_size):
    """The three passes all run: K2 at bf16x3 is within tests/test_pallas.py's
    limits (5e-5 object, 5e-4 pupil) of K2 at highest, where a plain sweep
    whose products keep only hi·hi is off by more than 1e-3."""
    from unittest import mock

    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "sequential")
    bo, bp, _ = two_sweeps(kernels.fused_epry_sweep, planes, rest, common)
    ho, hp, _ = two_sweeps(kernels.fused_epry_sweep, planes, rest,
                           dict(common, dft_precision="highest"))
    assert rel(bo, ho) < 5e-5 and rel(bp, hp) < 5e-4

    def hi_hi(a, b):
        return ((a if isinstance(a, tuple) else kernels._csplit(a))[0]
                @ (b if isinstance(b, tuple) else kernels._csplit(b))[0])

    with mock.patch.object(kernels, "cmm_bf16x3", hi_hi):
        oo, op, _ = two_sweeps(kernels.fused_epry_sweep_plain, planes, rest, common)
    assert max(rel(oo, ho), rel(op, hp)) > 1e-3


@pytest.mark.parametrize("stem", ["epry_sweep", "epry_chunked", "epry_increments"])
def test_bf16x3_instantiations_hold_tensor_core_products(cuda, stem):
    """HMMA instructions in each library's SASS, all of them in the bf16x3
    tier's code (the tensor-core product or the tier-1 instantiations), none
    in the highest tier's kernels."""
    import re

    from fpm_torch.ops import build

    counts = build.hmma_counts(stem)
    assert sum(counts.values()) > 0, counts
    for name, c in counts.items():        # cu++filt writes a tier as <(int)1>
        if re.search(r"<(\(int\))?0>|ILi0E", name):
            assert c == 0, name
        elif c:
            assert re.search(r"cgemm_tc|<(\(int\))?1>|ILi1E", name), name


def test_a_cluster_size_that_is_no_power_of_two_up_to_8_is_refused(cuda, force_cluster):
    ds = synthetic_dataset(np_size=16, grid=5, seed=3)
    (o, p, sup), rest, common = operands(ds, cuda, "sequential")
    force_cluster(kernels.fused_epry_sweep, 3)
    before = kernels.fused_epry_sweep.launches
    with pytest.raises(RuntimeError, match="K2"):
        kernels.fused_epry_sweep(o, p, sup, *rest, **common)
    assert kernels.fused_epry_sweep.launches == before


@pytest.mark.parametrize("kw", [dict(), dict(mode="batched", chunk_size=8)])
def test_reconstruct_on_the_card_matches_the_cpu(cuda, kw):
    ds = synthetic_dataset(np_size=32, grid=7, seed=1)
    gpu = epry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=3, use_pallas=True, **kw)
    cpu = epry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=3, use_pallas=True,
                           device="cpu", **kw)
    scale = np.abs(cpu.obj_f_centered).max()
    assert np.abs(gpu.obj_f_centered - cpu.obj_f_centered).max() / scale < TOL_O
    assert np.abs(gpu.pupil - cpu.pupil).max() / np.abs(cpu.pupil).max() < TOL_P


def test_kernel_refuses_wrong_operands(cuda):
    ds = synthetic_dataset(np_size=16, grid=5, seed=3)
    (o, p, sup), (amps, starts), common = operands(ds, cuda, "sequential")
    with pytest.raises(ValueError, match="float32"):
        kernels.fused_epry_sweep(o, p, sup, amps.double(), starts, **common)
    with pytest.raises(ValueError, match="is on"):
        kernels.fused_epry_sweep(o, p, sup, amps.cpu(), starts, **common)
    with pytest.raises(ValueError, match="shapes"):
        kernels.fused_epry_sweep(o, p, sup, amps, starts[:-2], **common)


def test_out_of_range_starts_are_clamped_like_the_plain_version(cuda):
    """Starts past the spectrum are clamped (as JAX's crop clamps), never
    read out of bounds."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=3)
    (o, p, sup), (amps, starts), common = operands(ds, cuda, "sequential")
    far = starts + torch.tensor([10 * ds.cfg.n_large, -5], dtype=torch.int32,
                                device=cuda).repeat(starts.numel() // 2)
    ko, kp, _ = kernels.fused_epry_sweep(o, p, sup, amps, far, **common)
    po, pp, _ = kernels.fused_epry_sweep_plain(o, p, sup, amps, far, **common)
    assert rel(ko, po) < TOL_O and rel(kp, pp) < TOL_P
    with pytest.raises(ValueError, match="shapes"):
        kernels.fused_epry_sweep(o, p, sup, amps[:-1], starts, **common)


def k3_d_limit(args, kw, pd, cpu_witness=False):
    """The limit on K3's d against the plain version's ``pd``: TOL_O, and at
    bf16x3 no tighter than the tier's own distance from FP32 on this call
    (plain bf16x3 d against plain highest d). d is a sum of increments much
    smaller than the terms they come from, and the tier's split is not a
    smooth function of its input (a last-bit change of a product's f32 result
    may move lo by one bf16 step, 2^-17 of the value), so kernel and plain
    version, whose f32 sums differ in order, part by more than at highest.
    ``cpu_witness`` (the dogStomach patch, where two f32 summation orders of
    d part by more than 1e-5 at either tier): also no tighter than the plain
    version on the CPU lies from ``pd`` (chip_smoke.py k3_d_limit)."""
    limit = TOL_O
    if cpu_witness:
        cpu_d = kernels.fused_chunk_increments_plain(*(t.cpu() for t in args), **kw)[0]
        limit = max(limit, rel(pd.cpu(), cpu_d))
    if kw["dft_precision"] == "highest":
        return limit
    hd = kernels.fused_chunk_increments_plain(*args, **dict(kw, dft_precision="highest"))[0]
    return max(limit, rel(pd, hd))


def k3_operands(ds, dev, block, tier="bf16x3"):
    """One chunk on the init state. ``square``: the whole spectrum, chunk 0
    of the chunk-8 schedule (its padding slot masked); ``tile``: tile 1 of 3
    extended by its halo, that tile's chunk-0 workset (padded slots masked,
    starts relative to the block)."""
    (o, p, sup), (amps, starts), common = operands(ds, dev, "sequential", tier=tier)
    n, nl, k = ds.cfg.np_size, ds.cfg.n_large, ds.geom.num_leds
    if block == "square":
        perm, _, n_chunks = epry.chunk_schedule(k, 8, "strided")
        sel = perm.reshape(n_chunks, 8)[0]
        sel = np.where(sel < k, sel, -1)
        row0 = 0
    else:
        idx, s = partition_leds_by_tile(ds.geom, nl, 3, 1, n, chunk_size=8)
        sel, row0 = idx[0, 0, 1], s
        o = o[:, s:2 * s + n].contiguous()
        assert (sel < 0).any() and (sel >= 0).sum() > 1
    live = torch.as_tensor(sel >= 0, device=dev)
    pick = torch.as_tensor(np.where(sel >= 0, sel, 0), device=dev)
    st = starts.view(-1, 2)[pick] - torch.tensor([row0, 0], dtype=torch.int32, device=dev)
    st = st * live[:, None].to(torch.int32)
    common = {k_: v for k_, v in common.items() if k_ not in ("n_large", "collect_metrics")}
    return (o, p, sup, amps[pick] * live[:, None, None], st.reshape(-1).contiguous(),
            live.to(torch.int32)), dict(common, n_rows=o.shape[1], n_cols=o.shape[2])


@pytest.mark.parametrize("np_size", [16, 64, 100])
@pytest.mark.parametrize("block", ["square", "tile"])
@pytest.mark.parametrize("collect_metrics", [True, False])
def test_k3_matches_plain(cuda, tier, np_size, block, collect_metrics):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    args, kw = k3_operands(ds, cuda, block, tier)
    before = kernels.fused_chunk_increments.launches
    kd, kv, km = kernels.fused_chunk_increments(*args, collect_metrics=collect_metrics, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_chunk_increments.launches == before + 3
    pd, pv, pm = kernels.fused_chunk_increments_plain(*args, collect_metrics=collect_metrics,
                                                      **kw)
    assert kd.shape == args[0].shape and kv.shape == args[1].shape
    assert rel(kd, pd) < k3_d_limit(args, dict(kw, collect_metrics=collect_metrics), pd)
    assert rel(kv, pv) < TOL_P
    if collect_metrics:
        np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), rtol=TOL_M)
    else:
        assert (km == 0).all() and (pm == 0).all()
    outside = torch.as_tensor(pupil_support(ds.cfg), device=cuda) == 0
    assert kv[:, outside].abs().max().item() == 0.0
    assert kd[:, pd[0] == 0].abs().max().item() == 0.0     # nothing outside the valid windows
    # A masked slot is never read: poison its frame and its start.
    o, p, sup, amps, starts, valid = args
    amps, starts = amps.clone(), starts.clone()
    amps[valid == 0] = float("nan")
    starts.view(-1, 2)[valid == 0] = 10 ** 6
    jd, jv, jm = kernels.fused_chunk_increments(o, p, sup, amps, starts, valid,
                                                collect_metrics=collect_metrics, **kw)
    assert torch.equal(jd, kd) and torch.equal(jv, kv) and torch.equal(jm, km)


@pytest.mark.parametrize("cs", [1, 2, 8])
def test_k3_masked_slots_are_never_read_at_a_forced_cluster_size(cuda, tier, force_cluster,
                                                                 cs):
    """A masked slot's whole cluster leaves before its first barrier: with
    its frame and start poisoned the call neither hangs nor changes."""
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    (o, p, sup, amps, starts, valid), kw = k3_operands(ds, cuda, "tile", tier)
    force_cluster(kernels.fused_chunk_increments, cs)
    kd, kv, km = kernels.fused_chunk_increments(o, p, sup, amps, starts, valid, **kw)
    assert kernels.fused_chunk_increments.cluster_size == cs
    pd, pv, pm = kernels.fused_chunk_increments_plain(o, p, sup, amps, starts, valid, **kw)
    limit = k3_d_limit((o, p, sup, amps, starts, valid), kw, pd)
    assert rel(kd, pd) < limit and rel(kv, pv) < TOL_P
    np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), rtol=TOL_M)
    amps, starts = amps.clone(), starts.clone()
    amps[valid == 0] = float("nan")
    starts.view(-1, 2)[valid == 0] = 10 ** 6
    jd, jv, jm = kernels.fused_chunk_increments(o, p, sup, amps, starts, valid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(jd, kd) and torch.equal(jv, kv) and torch.equal(jm, km)


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 3), (1, 6)])
def test_sharded_sweep_on_the_card_matches_k1(cuda, led, tile):
    """All ranks share the one card; (1,6): tile height 8 below Np=16."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    kw = dict(iterations=3, chunk_size=8, use_pallas=True)
    single = epry.reconstruct(ds.images, ds.geom, ds.cfg, mode="batched", **kw)
    mesh = make_mesh(led=led, tile=tile)
    assert mesh.size == led * tile and all(d.type == "cuda" for row in mesh.devices for d in row)
    before = kernels.fused_chunk_increments.launches
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    got = fn(ds.images, ds.geom, ds.cfg, mesh=mesh, **kw)
    assert kernels.fused_chunk_increments.launches == before + 3 * 3 * 3 * led * tile
    scale = np.abs(single.obj_f_centered).max()
    assert np.abs(got.obj_f_centered - single.obj_f_centered).max() / scale < TOL_O
    assert np.abs(got.pupil - single.pupil).max() / np.abs(single.pupil).max() < TOL_P
    np.testing.assert_allclose(got.metrics["update_norm"], single.metrics["update_norm"],
                               rtol=TOL_M)
    with pytest.raises(ValueError, match="use_pallas"):
        fn(ds.images, ds.geom, ds.cfg, mesh=mesh, iterations=1, chunk_size=8)


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_a_sweep_over_several_cards_keeps_the_current_device(cuda, led, tile):
    """One process drives ranks on every visible card; each kernel entry
    point makes its rank's card current for its launches and gives the
    caller's back, for PyTorch and for the CUDA runtime alike."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two CUDA devices: the ranks of one mesh on different cards")
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    kw = dict(iterations=2, chunk_size=8, use_pallas=True)
    mesh = make_mesh(led=led, tile=tile)
    assert len({d.index for row in mesh.devices for d in row}) == min(n_cards, led * tile)
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    for current in (0, n_cards - 1):
        with torch.cuda.device(current):
            got = fn(ds.images, ds.geom, ds.cfg, mesh=mesh, **kw)
            assert torch.cuda.current_device() == current
            # A launch on another card straight through the wrapper
            # (current_device asks the CUDA runtime, not a cached value).
            other = torch.device("cuda", (current + 1) % n_cards)
            args, k3_kw = k3_operands(ds, other, "square")
            kernels.fused_chunk_increments(*args, **k3_kw)
            assert torch.cuda.current_device() == current
    single = epry.reconstruct(ds.images, ds.geom, ds.cfg, mode="batched", **kw)
    scale = np.abs(single.obj_f_centered).max()
    assert np.abs(got.obj_f_centered - single.obj_f_centered).max() / scale < TOL_O
    assert np.abs(got.pupil - single.pupil).max() / np.abs(single.pupil).max() < TOL_P


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_kernels_refuse_an_np_whose_buffers_do_not_fit_a_block(cuda, tier, kernel):
    """A block holds its slabs of the image plane and of T = Ai·Z and its rows
    of Z: Np 90, 100 and 200 fit (the cases above and below), and so does
    the whole patch as the bbox up to b = n = 226; b = n = 240 fits at no
    cluster size and is refused before any launch."""
    n, nl = 240, 480
    o = torch.zeros((2, nl, nl), device=cuda)
    p, sup = torch.ones((2, n, n), device=cuda), torch.ones((n, n), device=cuda)
    amps = torch.ones((1, 1, n, n), device=cuda)
    starts = torch.zeros(2, dtype=torch.int32, device=cuda)
    common = dict(np_size=n, n_large=nl, delta1=5.0, delta2=10.0, eps=1e-10, dft_precision=tier)
    wrappers = (kernels.fused_epry_chunked, kernels.fused_epry_sweep,
                kernels.fused_chunk_increments)
    before = [w.launches for w in wrappers]
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="shared memory"):
        if kernel == "K1":
            kernels.fused_epry_chunked(o, p, sup, amps, starts, one, **common)
        elif kernel == "K2":
            kernels.fused_epry_sweep(o, p, sup, amps[0], starts, **common)
        else:
            common.pop("n_large")
            kernels.fused_chunk_increments(o, p, sup, amps[0], starts, one, n_rows=nl,
                                           n_cols=nl, **common)
    assert [w.launches for w in wrappers] == before


@pytest.fixture
def force_layout():
    """Sets a wrapper's test-only layout of Z (1 whole, 2 cut by rows), and
    takes it back."""
    touched = []

    def force(wrapper, layout):
        touched.append(wrapper)
        wrapper.force_z_layout = layout

    yield force
    for wrapper in touched:
        wrapper.force_z_layout = 0


def kernel_call(kernel, ds, dev, tier, chunk=7, k3_block="tile"):
    """(wrapper, plain version, operands, options) of one call of K1 (at
    the chunk the kernel route runs for ``chunk``), K2 or K3 on ``ds``."""
    if kernel == "K3":
        args, kw = k3_operands(ds, dev, k3_block, tier)
        return (kernels.fused_chunk_increments, kernels.fused_chunk_increments_plain, args,
                dict(kw, collect_metrics=True))
    mode = "sequential" if kernel == "K2" else "batched"
    planes, rest, common = operands(ds, dev, mode, chunk, tier)
    if kernel == "K2":
        return kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain, (*planes, *rest), common
    return (kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain, (*planes, *rest),
            common)


@pytest.mark.parametrize("np_size", [90, 100])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_z_cut_by_rows_is_bitwise_z_whole(cuda, tier, force_cluster, force_layout, np_size,
                                          kernel):
    """Both layouts of Z: whole in every block (what the entry points take
    where it fits, as at Np 90 and 100) and cut by rows across the cluster
    (product 1 reading each row from the block that built it). At every
    cluster size either gives the result of cs 1, bit for bit."""
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    fn, _, args, kw = kernel_call(kernel, ds, cuda, tier)
    fn(*args, **kw)
    assert fn.plan["zcut"] == 0
    force_cluster(fn, 1)
    first = fn(*args, **kw)
    for cs in (2, 4, 8):
        force_cluster(fn, cs)
        for layout in (1, 2):
            force_layout(fn, layout)
            out = fn(*args, **kw)
            assert fn.plan["cs"] == cs and fn.plan["zcut"] == layout - 1
            assert all(torch.equal(a, b) for a, b in zip(out, first)), (cs, layout)


@pytest.fixture(scope="module")
def dog_stomach():
    """The dogStomach problem (tests/test_torch_np200.py): Np 200, NL 600, K
    88, bbox 112 at offset 48."""
    from fpm_torch.config import FPMConfig
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry

    cfg = FPMConfig(np_size=200, pixel_size=6.5, objective_mag=8.0, objective_na=0.2,
                    max_illumination_na=0.30, wavelength=0.63)
    geom = compute_geometry(cfg)
    images = simulate_images(make_test_object(cfg.n_large, seed=0), geom, cfg, quantize=True)
    return types.SimpleNamespace(cfg=cfg, geom=geom, images=images)


@pytest.mark.parametrize("bbox", ["NA disk", "whole patch"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_dogstomach_kernels_match_plain(cuda, tier, force_layout, dog_stomach, kernel, bbox):
    """Np 200 at the dogStomach bbox (112: cs 8 with Z whole, the only size
    that fits; the same bitwise with Z cut by rows) and with the whole
    patch as the bbox (pupil_radius 0, b = n = 200: Z cut by rows), against
    the plain versions; K1 at the chunk the kernel route runs (16), K3 on
    chunk 0 of the chunk-8 schedule on the whole spectrum. K3's d is held
    at k3_d_limit, its v at TOL_P, and what the sharded sweep makes of
    them, O + d and P + v / max|O + d|, at TOL_O / TOL_P."""
    ds = dog_stomach
    fn, plain, args, kw = kernel_call(kernel, ds, cuda, tier, chunk=32, k3_block="square")
    assert kernel != "K1" or args[3].shape[1] == 16
    if bbox == "whole patch":
        kw = dict(kw, pupil_radius=0)
    b = kernels.bbox_extent(200, kw["pupil_radius"])[0]
    assert b == (112 if bbox == "NA disk" else 200)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.plan["cs"] == 8 and fn.plan["br"] == -(-b // 8)
    assert fn.plan["zcut"] == (0 if b == 112 else 1)
    want = plain(*args, **kw)
    if kernel == "K3":
        def applied(out):
            o = args[0] + out[0]
            return o, args[1] + out[1] / (o[0] * o[0] + o[1] * o[1]).max().sqrt()
        got_s, want_s = applied(got), applied(want)
        assert rel(got[0], want[0]) < k3_d_limit(args, kw, want[0], cpu_witness=True)
        assert rel(got[1], want[1]) < TOL_P
    else:
        got_s, want_s = got, want
    assert rel(got_s[0], want_s[0]) < TOL_O and rel(got_s[1], want_s[1]) < TOL_P
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=TOL_M)
    assert all(torch.equal(a, b_) for a, b_ in zip(fn(*args, **kw), got))
    if b == 112:
        force_layout(fn, 2)
        assert all(torch.equal(a, b_) for a, b_ in zip(fn(*args, **kw), got))
        assert fn.plan["zcut"] == 1


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_ablated_kernels_cut_z_by_rows_at_b_equal_n(cuda, tier, dog_stomach, kernel):
    """Np 200 with the whole patch as the bbox (pupil_radius 0, b = n =
    200: Z cut by rows, where the ablation build once refused every
    variant): each variant plans Z cut, lies within ABLATE_TOL of its plain
    version after one sweep, and ``ablate=""`` through the ablation build is
    bitwise the main Z-cut kernel. dft-1pass at bf16x3 alone, as chip_smoke.py
    runs it."""
    fn, plain, args, kw = kernel_call(kernel, dog_stomach, cuda, tier, chunk=32)
    kw = dict(kw, pupil_radius=0)
    main = fn(*args, **kw)
    assert fn.plan["zcut"] == 1
    for ablate in ablation_names(kernel, tier):
        state = ablation_inputs(args, ablate, 200)
        got = fn(*state, **kw, ablate=ablate)
        assert fn.plan["zcut"] == 1, ablate
        want = plain(*state, **kw, ablate=ablate)
        tol_o, tol_p, tol_m = ABLATE_TOL.get(ablate, (TOL_O, TOL_P, TOL_M))
        assert rel(got[0], want[0]) < tol_o, ablate
        assert rel(got[1], want[1]) < tol_p, ablate
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=tol_m)
    fn.force_ablation_build = True
    try:
        again = fn(*args, **kw)
    finally:
        fn.force_ablation_build = False
    assert fn.plan["zcut"] == 1
    assert all(torch.equal(a, b_) for a, b_ in zip(main, again))


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_ablated_kernels_are_bitwise_with_z_cut_and_z_whole(cuda, tier, force_layout, kernel):
    """At the mono shape (Np 90, where Z whole fits) each variant with Z cut
    by rows (force_z_layout 2) is bitwise the same variant with Z whole (1)."""
    ds = synthetic_dataset(np_size=90, grid=5, seed=3)
    fn, _, args, kw = kernel_call(kernel, ds, cuda, tier)
    b, _ = kernels.bbox_extent(90, kw["pupil_radius"])
    for ablate in ablation_names(kernel, tier):
        state = ablation_inputs(args, ablate, b)
        out = {}
        for layout in (1, 2):
            force_layout(fn, layout)
            out[layout] = fn(*state, **kw, ablate=ablate)
            assert fn.plan["zcut"] == layout - 1, ablate
        assert all(torch.equal(a, b_) for a, b_ in zip(out[1], out[2])), ablate


def test_init_state_on_the_card_is_reconstructs_init(cuda):
    """``init_state`` on the card within 1e-6 of the init that ``reconstruct``
    starts from (0 sweeps), and of the same function on the CPU."""
    ds = synthetic_dataset(np_size=90, grid=5, seed=3)
    amps, _ = epry._sorted_device_inputs(ds.images, ds.geom, torch.complex64, cuda)
    o, p, sup = epry.init_state(ds.cfg, ds.geom, amps)
    assert o.is_cuda and p.is_cuda and sup.is_cuda and sup.dtype == torch.complex64
    res = epry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=0, use_pallas=True)
    assert rel(o.cpu(), torch.from_numpy(res.obj_f_centered)) < 1e-6
    assert rel(p.cpu(), torch.from_numpy(res.pupil)) < 1e-6
    o_cpu, p_cpu, _ = epry.init_state(ds.cfg, ds.geom, amps.cpu(), device="cpu")
    assert rel(o.cpu(), o_cpu) < 1e-6 and torch.equal(p.cpu(), p_cpu)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_kernel_sweeps_on_the_card_are_the_wrappers(cuda, tier, mode):
    """``sweep_pallas`` (K2) and ``sweep_batched_pallas`` (K1) on the card:
    bitwise the kernel wrapper they call on the same planes, and each
    launches that kernel only."""
    ds = synthetic_dataset(np_size=90, grid=5, seed=3)
    opts = epry.EPRYOptions.from_config(ds.cfg, use_pallas=True, mode=mode, chunk_size=8,
                                        dft_precision=tier)
    amps, starts = epry._sorted_device_inputs(ds.images, ds.geom, torch.complex64, cuda)
    o, p, sup = epry.init_state(ds.cfg, ds.geom, amps)
    planes = (epry._to_planes(o), epry._to_planes(p), sup.real)
    kw = dict(np_size=ds.cfg.np_size, n_large=ds.cfg.n_large, delta1=ds.cfg.delta1,
              delta2=ds.cfg.delta2, eps=ds.cfg.eps, pupil_radius=opts.pupil_radius,
              collect_metrics=opts.collect_metrics, dft_precision=tier)
    wrappers = {"K1": kernels.fused_epry_chunked, "K2": kernels.fused_epry_sweep}
    before = {k: w.launches for k, w in wrappers.items()}
    if mode == "sequential":
        key = "K2"
        got = epry.sweep_pallas(o, p, amps, starts, support=sup, opts=opts)
        want = kernels.fused_epry_sweep(*planes, amps, starts.reshape(-1),
                                        global_max=opts.global_max, **kw)
    else:
        key = "K1"
        a, s, m = epry.chunk_permute(amps, starts, 8, "strided", torch.float32)
        got = epry.sweep_batched_pallas(o, p, a, s, m, support=sup, opts=opts)
        want = kernels.fused_epry_chunked(*planes, a, s.reshape(-1),
                                          (m > 0).reshape(-1).to(torch.int32),
                                          pupil_step_scale=opts.pupil_step_scale, **kw)
    moved = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert moved[key] > 0 and all(v == 0 for k, v in moved.items() if k != key)
    assert torch.equal(got[0], torch.complex(want[0][0], want[0][1]))
    assert torch.equal(got[1], torch.complex(want[1][0], want[1][1]))
    assert torch.equal(got[2], want[2])


# ------------------------------------------------------------- problem axis


def problem_stack(ds, dev, mode, n_prob, chunk=7, tier="bf16x3"):
    """``n_prob`` problems of one geometry (the frames scaled and offset per
    problem), each with its own init state, as the (P, ...) operands of one
    problem-axis call."""
    stacks = [ds.images * (1.0 + 0.05 * q) + q for q in range(n_prob)]
    per = [operands(dataclasses.replace(ds, images=images), dev, mode, chunk, tier)
           for images in stacks]
    planes = (torch.stack([p[0][0] for p in per]), torch.stack([p[0][1] for p in per]),
              per[0][0][2])
    rest = (torch.stack([p[1][0] for p in per]),) + per[0][1][1:]
    return planes, rest, per[0][2], per


@pytest.mark.parametrize("n_prob", [2, 3, 17])
@pytest.mark.parametrize("cs", [1, 2, 8])
@pytest.mark.parametrize("kernel,mode", [("K2", "sequential"), ("K2 lazy", "sequential"),
                                         ("K1", "batched")])
def test_problem_axis_is_bitwise_each_problem_alone(cuda, tier, force_cluster, kernel, mode,
                                                   n_prob, cs):
    """Problem q of a P-problem launch at a forced cluster size equals
    problem q solved alone by a single-problem launch at the size its entry
    point chooses, bit for bit, metrics included: nothing depends on P or on
    the cluster size. The launches per sweep do not grow with P."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=3)
    planes, rest, common, per = problem_stack(ds, cuda, mode, n_prob, tier=tier)
    fn = kernels.fused_epry_chunked if kernel == "K1" else kernels.fused_epry_sweep
    kw = dict(global_max="lazy") if kernel == "K2 lazy" else {}
    solo = [two_sweeps(fn, *p, **kw) for p in per]
    force_cluster(fn, cs)
    before = fn.launches
    o, p, m = two_sweeps(fn, planes, rest, common, **kw)
    torch.cuda.synchronize()
    assert fn.cluster_size == cs
    per_sweep = 2 if kernel != "K1" else 3 * rest[0].shape[1]
    assert fn.launches == before + 2 * per_sweep
    assert o.shape == planes[0].shape and p.shape == planes[1].shape and m.shape == (2, n_prob, 2)
    for q, (so, sp, sm) in enumerate(solo):
        assert torch.equal(o[q], so) and torch.equal(p[q], sp) and torch.equal(m[:, q], sm), q


@pytest.mark.parametrize("kernel,mode", [("K2", "sequential"), ("K1", "batched")])
def test_a_nan_problem_leaves_every_other_problem_unchanged(cuda, tier, kernel, mode):
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    planes, (amps, *shared), common, per = problem_stack(ds, cuda, mode, 4, tier=tier)
    fn = kernels.fused_epry_chunked if kernel == "K1" else kernels.fused_epry_sweep
    amps = amps.clone()
    amps[1] = float("nan")
    o, p, m = two_sweeps(fn, planes, (amps, *shared), common)
    assert not torch.isfinite(o[1]).all()
    for q in (0, 2, 3):
        so, sp, sm = two_sweeps(fn, *per[q])
        assert torch.equal(o[q], so) and torch.equal(p[q], sp) and torch.equal(m[:, q], sm)


@pytest.mark.parametrize("kernel,mode", [("K2", "sequential"), ("K1", "batched")])
def test_problem_axis_matches_the_plain_version(cuda, tier, kernel, mode):
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    planes, rest, common, _ = problem_stack(ds, cuda, mode, 3, tier=tier)
    fn, plain = ((kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain) if kernel == "K1"
                 else (kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain))
    ko, kp, km = two_sweeps(fn, planes, rest, common)
    po, pp, pm = two_sweeps(plain, planes, rest, common)
    for q in range(3):
        assert rel(ko[q], po[q]) < TOL_O and rel(kp[q], pp[q]) < TOL_P
    np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), rtol=TOL_M)


@pytest.mark.parametrize("kw", [dict(), dict(mode="batched", chunk_size=8)])
def test_reconstruct_channels_is_bitwise_reconstruct(cuda, kw):
    from fpm_torch.models.epry import reconstruct_channels

    ds = synthetic_dataset(np_size=32, grid=5, seed=2, quantize=True)
    chans = [ds.images, ds.images * 0.8 + 1.0, ds.images * 1.2]
    before = kernels.fused_epry_sweep.launches + kernels.fused_epry_chunked.launches
    got = reconstruct_channels(chans, ds.geom, ds.cfg, iterations=3, use_pallas=True, **kw)
    launched = kernels.fused_epry_sweep.launches + kernels.fused_epry_chunked.launches - before
    k = ds.geom.num_leds
    n_chunks = -(-k // 8)
    assert launched == 3 * (2 if not kw else 3 * n_chunks)
    for images, res in zip(chans, got):
        alone = epry.reconstruct(images, ds.geom, ds.cfg, iterations=3, use_pallas=True, **kw)
        for key in ("obj_crop", "obj_f_centered", "pupil"):
            assert np.array_equal(getattr(res, key), getattr(alone, key)), key
        for key in ("data_residual", "update_norm"):
            assert np.array_equal(res.metrics[key], alone.metrics[key]), key


def write_rgb_dataset(tmp_path, np_size=16):
    """A simulated dataset whose frames are 8-bit RGB TIFFs: three objects
    (seeds 4, 5, 6) in the three planes."""
    import json
    import os

    from PIL import Image

    from fpm_torch import cli

    planes = []
    for seed in (4, 5, 6):
        d = str(tmp_path / f"gray{seed}")
        assert cli.main(["simulate", d, "--np-size", str(np_size), "--grid", "5",
                         "--seed", str(seed)]) == 0
        planes.append(d)
    data = tmp_path / "rgb"
    data.mkdir()
    for f in sorted(os.listdir(planes[0])):
        if f.endswith(".tif"):
            g = [np.asarray(Image.open(os.path.join(d, f))) for d in planes]
            g8 = [(np.clip(x, 0, 65535) / 257).astype(np.uint8) for x in g]
            Image.fromarray(np.stack(g8, axis=-1)).save(data / f)
    doc = json.load(open(os.path.join(planes[0], "dataset.json")))
    doc["datasetRoot"] = str(data) + os.sep
    path = str(tmp_path / "rgb.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_cli_rgb_on_the_card_is_bitwise_each_channel_alone(cuda, tmp_path, mode):
    import os

    from fpm_torch import cli
    from fpm_torch.config import load_config
    from fpm_torch.data.loader import load_dataset_rgb

    cfg_path = write_rgb_dataset(tmp_path)
    out = str(tmp_path / "out")
    assert cli.main(["run", cfg_path, "-n", "3", "-o", out, "--use-pallas", "--mode", mode,
                     "--chunk-size", "8", "--color-mode", "rgb",
                     "--watchdog-timeout", "60"]) == 0
    assert os.path.exists(os.path.join(out, "object_rgb.png"))
    cfg = load_config(cfg_path, iterations=3)
    for name, ch in zip(("red", "green", "blue"), load_dataset_rgb(cfg)):
        alone = epry.reconstruct(ch.images, ch.geom, cfg, iterations=3, use_pallas=True,
                                 mode=mode, chunk_size=8)
        assert np.array_equal(np.load(os.path.join(out, name, "object.npy")), alone.obj_crop)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_cli_fov_grid_on_the_card_is_bitwise_each_tile_alone(cuda, tmp_path, mode):
    import os

    from fpm_torch import cli
    from fpm_torch.config import load_config
    from fpm_torch.data.loader import load_dataset

    data = str(tmp_path / "data")
    assert cli.main(["simulate", data, "--np-size", "16", "--grid", "5",
                     "--frame-size", "48"]) == 0
    cfg_path = os.path.join(data, "dataset.json")
    out = str(tmp_path / "out")
    assert cli.main(["run", cfg_path, "-n", "3", "-o", out, "--use-pallas", "--mode", mode,
                     "--chunk-size", "8", "--fov-grid", "2", "2", "--checkpoint-every", "1",
                     "--watchdog-timeout", "60"]) == 0
    assert np.load(os.path.join(out, "object_stitched.npy")).shape == (84, 84)
    cfg = load_config(cfg_path, iterations=3)
    full = load_dataset(cfg, full_frames=True)
    for i, (y0, x0) in enumerate([(0, 0), (0, 12), (12, 0), (12, 12)]):
        roi = full.images[:, y0:y0 + 16, x0:x0 + 16]
        alone = epry.reconstruct(roi, full.geom, cfg, iterations=3, use_pallas=True, mode=mode,
                                 chunk_size=8)
        with np.load(os.path.join(out, "tiles", f"tile_{i:04d}.npz")) as z:
            crop = z["obj_crop_p"][0] + 1j * z["obj_crop_p"][1]
            assert np.array_equal(crop, alone.obj_crop), i
            assert np.array_equal(z["metrics"][:, 0], alone.metrics["data_residual"]), i


def test_amplitudes_on_the_card_are_numpys(cuda):
    """The frames' square root is taken on the card in float64: correctly
    rounded there as in NumPy, so the amplitudes are bitwise NumPy's."""
    ds = synthetic_dataset(np_size=32, grid=5, seed=2, quantize=True)
    for images in (ds.images.astype(np.uint16), ds.images * 1.37):
        for dtype, real in ((torch.complex64, np.float32), (torch.complex128, np.float64)):
            amps, starts = epry._sorted_device_inputs(images, ds.geom, dtype, cuda)
            want = np.sqrt(np.asarray(images, np.float64))[ds.geom.schedule].astype(real)
            assert np.array_equal(amps.cpu().numpy(), want)
            assert np.array_equal(starts.cpu().numpy(), ds.geom.crop_start[ds.geom.schedule])


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2), (1, 6)])
def test_entry_sweeps_are_bitwise_the_prepared_and_serialized_ones(cuda, led, tile, stale):
    """3 sweeps through the entry point against 3 sweeps on prepared grids
    and against the mesh with its streams serialized: bitwise, the same
    K3 launches and counted collectives, no host synchronisation inside a
    sweep."""
    from fpm_torch.parallel import comm, led_shard, tile_shard

    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    kw = dict(chunk_size=8, use_pallas=True, stale_consensus=stale)
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    before = kernels.fused_chunk_increments.launches
    entry_mesh = make_mesh(led, tile)
    got = fn(ds.images, ds.geom, ds.cfg, mesh=entry_mesh, iterations=3, **kw)
    assert kernels.fused_chunk_increments.launches == before + 3 * 3 * 3 * led * tile
    serial = fn(ds.images, ds.geom, ds.cfg, mesh=make_mesh(led, tile, serialize_streams=True),
                iterations=3, **kw)
    mesh = make_mesh(led, tile)
    if tile == 1:
        route, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def sweep():
            return led_shard._sharded_sweep(mesh, route, opts=opts)
    else:
        route, opts, s = tile_shard.prepare_tile_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def sweep():
            return tile_shard._tile_sweep(mesh, route, opts=opts, s=s)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            sweep()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert comm.consensus_schedule_check(mesh.schedule)["issued_before_compute"] is stale
    assert entry_mesh.counts == mesh.counts
    whole = route.obj if tile == 1 else [[tile_shard._fetch(mesh, route.obj)]]
    obj, pupil = route.final_state(mesh, whole[0][0])
    for res in (got, serial):
        np.testing.assert_array_equal(res.obj_f_centered, obj.cpu().numpy())
        np.testing.assert_array_equal(res.pupil, pupil.cpu().numpy())
