"""The CUDA kernels K1, K2 and K3 and the consensus kernels against their
plain PyTorch versions, a sharded sweep (K3 and the consensus kernels)
against the single-device one (K1), K1 and K2 with a
problem axis against solo launches (bitwise, at forced cluster sizes, with a
NaN problem), and the --fov-grid and --color-mode rgb runs per tile and per
channel against solo solves, on the card; the peer route's signal, wait
and pull kernels and its order, on one card and between two. They skip
without a CUDA device (the cases between cards need two). This file imports neither JAX nor fpm_tpu, so it also
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
    assert kernels.fused_epry_chunked.launches == before + 2 * 1     # one launch a sweep


@pytest.mark.parametrize("np_size", [16, 64, 90, 100])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_k2_matches_plain_at_a_forced_cluster_size(cuda, tier, force_cluster, np_size, cs):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "sequential", tier=tier)
    force_cluster(kernels.fused_epry_sweep, cs)
    assert_kernel_matches_plain(kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                                planes, rest, common)
    assert kernels.fused_epry_sweep.cluster_size == cs


@pytest.mark.parametrize("layout", [1, 2], ids=["Z whole", "Z cut"])
@pytest.mark.parametrize("np_size", [90, 100, 200])
def test_k2_products_on_split_operands_match_plain(cuda, tier, force_layout, request, np_size,
                                                   layout):
    """K2's four products on operands kept in the tile and row layouts
    (bf16x3), at Np 90, 100 and 200 (the dogStomach problem) with Z whole in
    every block and cut by rows across the cluster, against the plain
    version within the limits of every K2 case."""
    ds = (request.getfixturevalue("dog_stomach") if np_size == 200
          else synthetic_dataset(np_size=np_size, grid=5, seed=3))
    planes, rest, common = operands(ds, cuda, "sequential", tier=tier)
    force_layout(kernels.fused_epry_sweep, layout)
    assert_kernel_matches_plain(kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                                planes, rest, common)
    assert kernels.fused_epry_sweep.plan["zcut"] == layout - 1
    assert kernels.fused_epry_sweep.plan["cs"] > 1


def test_k2_ragged_contractions_are_bitwise_at_every_cluster_size(cuda, tier, force_cluster):
    """Np 90 with a bbox of 56: products 1 and 2 contract over b = 56 and 3
    and 4 over n = 90, neither a multiple of 16, so each contraction ends in
    a ragged k-step, which K2's layouts pad with zeros. Within the plain
    limits at cs 8, where each slab is skinny, and the same bits at cs 1,
    where a block holds every row."""
    ds = synthetic_dataset(np_size=90, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "sequential", tier=tier)
    b = kernels.bbox_extent(90, common["pupil_radius"])[0]
    assert b % 16 and 90 % 16
    fn = kernels.fused_epry_sweep
    force_cluster(fn, 8)
    assert_kernel_matches_plain(fn, kernels.fused_epry_sweep_plain, planes, rest, common)
    split = fn(*planes, *rest, **common)
    force_cluster(fn, 1)
    alone = fn(*planes, *rest, **common)
    assert fn.plan["cs"] == 1
    assert all(torch.equal(a, b_) for a, b_ in zip(split, alone))


class AtMappingEnd:
    """A copy of a CUDA tensor whose last byte is the last byte of its own
    mapping (the CUDA driver's virtual memory calls): the addresses past it
    are reserved and left unmapped, so a kernel that reads past the tensor
    faults instead of reading a neighbour. ``data_ptr()`` as a tensor's."""

    def __init__(self, t):
        import ctypes
        c = ctypes
        self.cu = cu = c.CDLL("libcuda.so.1")

        class Loc(c.Structure):
            _fields_ = [("type", c.c_int), ("id", c.c_int)]

        class Flags(c.Structure):
            _fields_ = [("compression", c.c_ubyte), ("rdma", c.c_ubyte), ("usage", c.c_ushort),
                        ("reserved", c.c_ubyte * 4)]

        class Prop(c.Structure):
            _fields_ = [("type", c.c_int), ("handle_types", c.c_int), ("location", Loc),
                        ("win32", c.c_void_p), ("flags", Flags)]

        class Access(c.Structure):
            _fields_ = [("location", Loc), ("flags", c.c_int)]

        def check(rc):
            assert rc == 0, f"CUDA driver error {rc}"

        here = Loc(1, t.device.index or 0)                    # CU_MEM_LOCATION_TYPE_DEVICE
        prop = Prop(type=1, location=here)                     # CU_MEM_ALLOCATION_TYPE_PINNED
        gran = c.c_size_t()
        check(cu.cuMemGetAllocationGranularity(c.byref(gran), c.byref(prop), 0))
        nbytes = t.numel() * t.element_size()
        self.size = -(-nbytes // gran.value) * gran.value
        self.handle, self.base = c.c_ulonglong(), c.c_ulonglong()
        check(cu.cuMemCreate(c.byref(self.handle), c.c_size_t(self.size), c.byref(prop),
                             c.c_ulonglong(0)))
        check(cu.cuMemAddressReserve(c.byref(self.base), c.c_size_t(2 * self.size),
                                     c.c_size_t(0), c.c_ulonglong(0), c.c_ulonglong(0)))
        check(cu.cuMemMap(self.base, c.c_size_t(self.size), c.c_size_t(0), self.handle,
                          c.c_ulonglong(0)))
        check(cu.cuMemSetAccess(self.base, c.c_size_t(self.size),
                                c.byref(Access(here, 3)), c.c_size_t(1)))  # read and write
        self.ptr = self.base.value + self.size - nbytes
        torch.cuda.synchronize()
        check(cu.cuMemcpyDtoD_v2(c.c_ulonglong(self.ptr), c.c_ulonglong(t.data_ptr()),
                                 c.c_size_t(nbytes)))
        torch.cuda.synchronize()

    def data_ptr(self):
        return self.ptr

    def free(self):
        import ctypes as c
        torch.cuda.synchronize()
        self.cu.cuMemUnmap(self.base, c.c_size_t(self.size))
        self.cu.cuMemAddressFree(self.base, c.c_size_t(2 * self.size))
        self.cu.cuMemRelease(self.handle)


@pytest.mark.parametrize("np_size", [90, 200])
def test_k2_reads_no_row_of_ai_past_its_padding(cuda, force_cluster, monkeypatch, request,
                                                np_size):
    """Ai (the row layout, n + 8 rows) as the last bytes of its own mapping:
    at cs 8 the last block's slab is short, and K2 reads, and at Np 90
    stages, only the rows its products read. The same bits as Ai in the
    caching allocator; a read past the padding would fault."""
    ds = (request.getfixturevalue("dog_stomach") if np_size == 200
          else synthetic_dataset(np_size=np_size, grid=5, seed=3))
    planes, rest, common = operands(ds, cuda, "sequential")
    fn = kernels.fused_epry_sweep
    force_cluster(fn, 8)
    want = fn(*planes, *rest, **common)
    assert fn.plan["cs"] == 8 and bool(fn.plan["stage"] & 4) == (np_size == 90)  # Ai staged
    real = kernels._k2_mats
    ai_end = []

    def at_end(n, b, lo, device):
        m = real(n, b, lo, device)
        ai_end.append(AtMappingEnd(m[0]))
        return (ai_end[-1], *m[1:])

    monkeypatch.setattr(kernels, "_k2_mats", at_end)
    try:
        got = fn(*planes, *rest, **common)
        torch.cuda.synchronize()
    finally:
        for m in ai_end:
            m.free()
    assert len(ai_end) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("np_size", [16, 64, 90, 100])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_k1_matches_plain_at_a_forced_cluster_size(cuda, tier, force_cluster, np_size, cs):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "batched", 7, tier)
    force_cluster(kernels.fused_epry_chunked, cs)
    assert_kernel_matches_plain(kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain,
                                planes, rest, common)
    assert kernels.fused_epry_chunked.cluster_size == cs


@pytest.mark.parametrize("chunk,n_chunks", [(21, 1), (3, 7)])
def test_k1_at_one_and_seven_chunks_with_masked_slots_matches_plain(cuda, tier, chunk, n_chunks):
    """K1's one launch walks every chunk in order, whatever their count, and
    skips masked dummy slots wherever they lie: the 21 LEDs in one chunk of
    21 and in seven chunks of 3, every fifth slot masked (valid 0)."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=3)
    planes, (amps, starts, valid), common = operands(ds, cuda, "batched", chunk, tier)
    assert amps.shape[:2] == (n_chunks, chunk)
    valid = valid.clone()
    valid[::5] = 0
    before = kernels.fused_epry_chunked.launches
    assert_kernel_matches_plain(kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain,
                                planes, (amps, starts, valid), common)
    assert kernels.fused_epry_chunked.launches == before + 2 * 1


@pytest.mark.parametrize("np_size,chunk", [(16, 7), (90, 32), (200, 16)])
def test_k1_grid_never_exceeds_the_resident_clusters(cuda, tier, np_size, chunk, tmp_path):
    """K1's one launch is a cooperative grid of the plan's clusters: the
    grid the card ran (read from a torch.profiler trace) is at most as many
    clusters of the plan's size as the card holds at once
    (``resident_clusters``, CUDA's occupancy query), and exactly the
    plan's ``resident``."""
    import json

    from torch.profiler import ProfilerActivity, profile

    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "batched", chunk, tier)
    o, p, sup = planes
    kernels.fused_epry_chunked(o, p, sup, *rest, **common)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # Late in a long process the profiler has been seen to lose a
        # window's first device records: short spin kernels go first.
        for _ in range(64):
            torch.cuda._sleep(1000)
        kernels.fused_epry_chunked(o, p, sup, *rest, **common)
        torch.cuda.synchronize()
    plan = kernels.fused_epry_chunked.plan
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    grids = [e["args"]["grid"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "kernel" and "k1_sweep" in e.get("name", "")]
    assert len(grids) == 1, grids
    resident = kernels.resident_clusters(kernels.fused_epry_chunked, np_size,
                                         common["pupil_radius"], rest[0].shape[1], plan["cs"],
                                         dft_precision=tier)
    assert grids[0] == [plan["resident"] * plan["cs"], 1, 1]
    assert 1 <= plan["resident"] <= resident


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


@pytest.mark.parametrize("np_size,chunk", [(16, 7), (90, 32)])
def test_k1_profile_build_counts_every_phase_and_changes_no_result(cuda, tier, np_size, chunk):
    """K1's cycle-counting build (a measurement aid the wrapper never
    loads) computes the same sweep, bit for bit, and every phase of a chunk
    gets cycles."""
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    (o, p, sup), rest, common = operands(ds, cuda, "batched", chunk, tier)
    plain_build = kernels.fused_epry_chunked(o, p, sup, *rest, **common)
    profiled, cycles = kernels.k1_phase_profile(o, p, sup, *rest, **common)
    for a, b in zip(plain_build, profiled):
        assert torch.equal(a, b)
    assert len(cycles) == 6 and all(c > 0 for c in cycles.values()), cycles


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
            assert re.search(r"<(\(int\))?1>|ILi1E", name), name


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
    assert kernels.fused_chunk_increments.launches == before + 1
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


# SHA-256 (first 16 hex digits) of K3's (d, v, mets) on k3_operands'
# "square" and "tile" blocks of synthetic_dataset(np_size=64, grid=5,
# seed=3), per tier, from the three launches a call made before K3 was one
# launch (H100, the same build flags).
K3_PARENT_DIGESTS = {("square", "bf16x3"): "d7e98b8172af7c25",
                     ("square", "highest"): "f9abda3dcb9d7788",
                     ("tile", "bf16x3"): "c4c0fba197854605",
                     ("tile", "highest"): "b28184e497c9965c"}


def k3_digest(out):
    import hashlib

    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("block", ["square", "tile"])
def test_k3_is_one_launch_and_bitwise_the_three_launches_it_replaces(cuda, tier, block):
    ds = synthetic_dataset(np_size=64, grid=5, seed=3)
    args, kw = k3_operands(ds, cuda, block, tier)
    before = kernels.fused_chunk_increments.launches
    out = kernels.fused_chunk_increments(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.fused_chunk_increments.launches == before + 1
    assert k3_digest(out) == K3_PARENT_DIGESTS[(block, tier)]


# The block shapes of the consensus on the main path: (NL, Np, bbox b,
# led, tile) of mono (4,1), (2,2), (1,8) and dogStomach (4,1), (2,2).
CONSENSUS_SHAPES = {"mono 4 1": (360, 90, 64, 4, 1), "mono 2 2": (360, 90, 64, 2, 2),
                    "mono 1 8": (360, 90, 64, 1, 8), "dogStomach 4 1": (600, 200, 112, 4, 1),
                    "dogStomach 2 2": (600, 200, 112, 2, 2)}


@pytest.mark.parametrize("wire", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CONSENSUS_SHAPES))
def test_consensus_kernels_are_bitwise_their_plain_versions(cuda, case, wire):
    """Each consensus kernel against its plain version on the card, on
    random payloads of the main path's shapes (one of them arrived as bf16
    on the bf16 wire): the state, max|O|, pupil and metric sums bitwise;
    one launch each."""
    nl, n, b, led, tile = CONSENSUS_SHAPES[case]
    g = torch.Generator().manual_seed(sum(CONSENSUS_SHAPES[case]))

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(cuda)

    s = nl // tile
    pc = rnd(2, b, b)
    ranks = [(li, ti) for li in range(led) for ti in range(tile)]
    vs = [rnd(2, b, b, scale=0.1) for _ in ranks]
    mets = [rnd(2).abs() for _ in ranks]
    resid, upd = [m[0] for m in mets], [m[1] for m in mets]
    acc = rnd(2).abs()
    if wire is not None:
        vs[-1] = vs[-1].to(wire)
    launches = [w.launches for w in (kernels.consensus_led, kernels.consensus_tile_object,
                                     kernels.consensus_tile_pupil)]
    if tile == 1:
        o = rnd(2, nl, nl, scale=10)
        ds = [rnd(2, nl, nl, scale=0.1) for _ in ranks]
        if wire is not None:
            ds[-1] = ds[-1].to(wire)
        scratch = kernels.ConsensusScratch(cuda)
        for a in (None, acc):
            got = kernels.consensus_led(o, pc, ds, vs, resid, upd, a, wire=wire, scale=0.75,
                                        scratch=scratch)
            want = kernels.consensus_led_plain(o, pc, ds, vs, resid, upd, a, wire=wire,
                                               scale=0.75)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert kernels.consensus_led.launches == launches[0] + 2
        return
    hops = [(j, lo, min(s, n - lo)) for j, lo in enumerate(range(0, n, s), start=1)]
    objs = [rnd(2, s, nl, scale=10) for _ in range(tile)]
    pay = {r: rnd(2, s + n, nl, scale=0.1) for r in ranks}
    if wire is not None:
        pay[ranks[-1]] = pay[ranks[-1]].to(wire)
    blocks = [(objs[ti], [pay[(li, ti)] for li in range(led)],
               [[pay[(li, (ti - j) % tile)] for li in range(led)] for j, _, _ in hops])
              for ti in range(tile)]
    got = kernels.consensus_tile_object(blocks, s=s, hops=hops, wire=wire,
                                        scratch=kernels.ConsensusScratch(cuda))
    for (o, m), blk in zip(got, blocks):
        wo, wm = kernels.consensus_tile_object_plain(*blk, s=s, hops=hops, wire=wire)
        assert torch.equal(o, wo) and torch.equal(m, wm)
    maxima = [m for _, m in got]
    got = kernels.consensus_tile_pupil(pc, vs, maxima, resid, upd, acc, wire=wire, scale=0.75)
    want = kernels.consensus_tile_pupil_plain(pc, vs, maxima, resid, upd, acc, wire=wire,
                                              scale=0.75)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert kernels.consensus_tile_object.launches == launches[1] + 1
    assert kernels.consensus_tile_pupil.launches == launches[2] + 1


# The paths of C1's and C2's object phase (kernels.consensus_plan): "vector"
# (16-byte chunks), "odd-nl" (NL not a multiple of 4: the scalar path) and
# "offset" (NL a multiple of 4, the last rank's payload a view one element
# into its buffer: the scalar path); the payloads' patterns (every rank
# f32, every rank bf16, odd ranks bf16) and both wires.
CONSENSUS_PATHS = ("vector", "odd-nl", "offset")
CONSENSUS_PATTERNS = ("f32", "bf16", "mixed")


def consensus_payloads(g, shape, count, pattern, path, cuda, scale=0.1):
    """``count`` payloads of ``shape`` in the ``pattern``; on the "offset"
    path the last one a view at one element into its buffer."""
    out = []
    for r in range(count):
        x = torch.randn(*shape, generator=g) * scale
        if pattern == "bf16" or (pattern == "mixed" and r % 2):
            x = x.to(torch.bfloat16)
        if path == "offset" and r == count - 1:
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
            out.append(buf[1:].view(shape).copy_(x))
        else:
            out.append(x.to(cuda))
    return out


@pytest.mark.parametrize("path", CONSENSUS_PATHS)
@pytest.mark.parametrize("count", [1, 2, 4, 8, 32])
def test_consensus_led_is_bitwise_its_plain_version_on_every_path(cuda, count, path):
    """C1 with 1 to kMaxRanks ranks, on each path, pattern and wire: the
    state, pupil (b = 40: two pupil blocks), max|O| and metric sums bitwise
    the plain version's; the path the plan chose is the one asked for."""
    nl, b = (62 if path == "odd-nl" else 64), 40
    g = torch.Generator().manual_seed(1000 * count + len(path))
    o = (torch.randn(2, nl, nl, generator=g) * 10).to(cuda)
    pc = torch.randn(2, b, b, generator=g).to(cuda)
    mets = [torch.randn(2, generator=g).abs().to(cuda) for _ in range(count)]
    acc = torch.randn(2, generator=g).abs().to(cuda)
    scratch = kernels.ConsensusScratch(cuda)
    for pattern in CONSENSUS_PATTERNS:
        ds = consensus_payloads(g, (2, nl, nl), count, pattern, path, cuda)
        vs = consensus_payloads(g, (2, b, b), count, pattern, "vector", cuda)
        plan = kernels.consensus_plan(nl * nl, aligned=kernels._aligned([o, *ds]), nl=nl,
                                      pupil=b * b)
        assert plan.vector == (path == "vector") and plan.pupil_blocks == 2
        for wire in (None, torch.bfloat16):
            for a in (None, acc):
                args = (o, pc, ds, vs, [m[0] for m in mets], [m[1] for m in mets], a)
                got = kernels.consensus_led(*args, wire=wire, scale=0.75, scratch=scratch)
                want = kernels.consensus_led_plain(*args, wire=wire, scale=0.75)
                assert all(torch.equal(x, y) for x, y in zip(got, want)), (pattern, wire)
    assert not scratch.sync.any()


@pytest.mark.parametrize("path", CONSENSUS_PATHS)
@pytest.mark.parametrize("tiles,count", [(1, 1), (2, 2), (3, 4), (4, 8), (8, 2), (2, 32)])
def test_consensus_tile_object_is_bitwise_its_plain_version_on_every_path(cuda, tiles, count,
                                                                          path):
    """C2 with 1 to 8 tiles of 24 rows, each with two halo hops (Np 40)
    from the tiles before it, ``count`` ranks a group, on each path,
    pattern and wire: each tile's state and max|O| bitwise the plain
    version's; the path the plan chose is the one asked for."""
    nl, s, n = (66 if path == "odd-nl" else 64), 24, 40
    hops = [(j, lo, min(s, n - lo)) for j, lo in enumerate(range(0, n, s), start=1)]
    g = torch.Generator().manual_seed(100 * tiles + count + len(path))
    objs = [(torch.randn(2, s, nl, generator=g) * 10).to(cuda) for _ in range(tiles)]
    scratch = kernels.ConsensusScratch(cuda)
    for pattern in CONSENSUS_PATTERNS:
        pay = {ti: consensus_payloads(g, (2, s + n, nl), count, pattern, path, cuda)
               for ti in range(tiles)}
        blocks = [(objs[ti], pay[ti], [pay[(ti - j) % tiles] for j, _, _ in hops])
                  for ti in range(tiles)]
        plan = kernels.consensus_plan(s * nl, nl=nl, aligned=kernels._aligned(
            objs + [t for ts in pay.values() for t in ts]))
        assert plan.vector == (path == "vector") and plan.pupil_blocks == 0
        for wire in (None, torch.bfloat16):
            got = kernels.consensus_tile_object(blocks, s=s, hops=hops, wire=wire,
                                                scratch=scratch)
            for (o, m), blk in zip(got, blocks):
                wo, wm = kernels.consensus_tile_object_plain(*blk, s=s, hops=hops, wire=wire)
                assert torch.equal(o, wo) and torch.equal(m, wm), (pattern, wire)
    assert not scratch.sync.any()


def same_bits(x, y) -> bool:
    """Bitwise equal, a NaN where the other has one (whatever its bits)."""
    nan = torch.isnan(x)
    return bool(torch.equal(nan, torch.isnan(y)) and torch.equal(x[~nan], y[~nan]))


@pytest.mark.parametrize("b,count", [(64, 1), (64, 32), (112, 1), (112, 32)])
def test_consensus_tile_pupil_is_bitwise_its_plain_version_on_every_path(cuda, b, count):
    """C3 with ``count`` ranks (1 and kMaxRanks) at b 64 (b² sixteen blocks
    of 256 exactly) and 112 (not a multiple of a block): f32, bf16 and mixed
    payloads, both wires, metrics kept or not, the sweep's sums given or
    not, 1 to 8 tile maxima with and without a NaN among them: the pupil,
    max|O| and metric sums bitwise the plain version's, one launch a call."""
    g = torch.Generator().manual_seed(10 * b + count)
    pc = torch.randn(2, b, b, generator=g).to(cuda)
    mets = [torch.randn(2, generator=g).abs().to(cuda) for _ in range(count)]
    resid, upd = [m[0] for m in mets], [m[1] for m in mets]
    acc = torch.randn(2, generator=g).abs().to(cuda)
    tile_max = [(torch.rand((), generator=g) * 10).to(cuda) for _ in range(8)]
    wrapper = kernels.consensus_tile_pupil
    for pattern in CONSENSUS_PATTERNS:
        vs = consensus_payloads(g, (2, b, b), count, pattern, "vector", cuda)
        for n_max in range(1, 9):
            for nan_at in (None, n_max // 2):
                maxima = list(tile_max[:n_max])
                if nan_at is not None:
                    maxima[nan_at] = torch.tensor(float("nan"), device=cuda)
                for wire in (None, torch.bfloat16):
                    for metrics in (True, False):
                        for a in (None, acc):
                            args = (pc, vs, maxima, resid, upd, a)
                            kw = dict(wire=wire, scale=0.75, metrics=metrics)
                            before = wrapper.launches
                            got = wrapper(*args, **kw)
                            assert wrapper.launches == before + 1
                            want = kernels.consensus_tile_pupil_plain(*args, **kw)
                            assert all(x is None and y is None or same_bits(x, y)
                                       for x, y in zip(got, want)), (
                                pattern, n_max, nan_at, wire, metrics)


@pytest.mark.parametrize("case", ["a block short", "a block past", "no block"])
def test_a_pupil_plan_that_does_not_cover_the_pupil_once_raises(cuda, monkeypatch, case):
    """The C entry checks C3's plan again: a grid that leaves an element out
    or holds a block without one is refused, and nothing is launched."""
    b = 64
    plan = kernels.pupil_plan(b * b)
    blocks = {"a block short": plan.pupil_blocks - 1, "a block past": plan.pupil_blocks + 1,
              "no block": 0}[case]
    pc = torch.randn(2, b, b, device=cuda)
    vs = [torch.randn(2, b, b, device=cuda)]
    one = torch.ones((), device=cuda)
    monkeypatch.setattr(kernels, "pupil_plan", lambda bb: plan._replace(pupil_blocks=blocks))
    before = kernels.consensus_tile_pupil.launches
    with pytest.raises(RuntimeError, match="consensus_tile_pupil"):
        kernels.consensus_tile_pupil(pc, vs, [one], [one], [one])
    assert kernels.consensus_tile_pupil.launches == before


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
    assert kernels.fused_chunk_increments.launches == before + 3 * 3 * led * tile
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
    the whole patch as the bbox up to b = n = 226 at highest (at bf16x3,
    where all three kernels keep their operands in the tile and row
    layouts: 256); b = n = 240 (bf16x3: 272) fits at no cluster size and is
    refused before any launch."""
    n = 272 if tier == "bf16x3" else 240
    nl = 2 * n
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
    per_sweep = 2 if kernel != "K1" else 1
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
    assert launched == 3 * (2 if not kw else 1)
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
    consensus = ([kernels.consensus_led] if tile == 1
                 else [kernels.consensus_tile_object, kernels.consensus_tile_pupil])
    before = [w.launches for w in (kernels.fused_chunk_increments, *consensus)]
    entry_mesh = make_mesh(led, tile)
    got = fn(ds.images, ds.geom, ds.cfg, mesh=entry_mesh, iterations=3, **kw)
    # 3 sweeps of 3 chunks: each rank's K3 and, on the one card, the
    # chunk's consensus launches.
    after = [w.launches for w in (kernels.fused_chunk_increments, *consensus)]
    assert [a - b for a, b in zip(after, before)] == [3 * 3 * led * tile] + [3 * 3] * len(consensus)
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


def sharded_entry(ds, led, tile, mesh=None, **kw):
    """A run through the entry point (3 sweeps, chunk 8: 3 chunks) on
    ``mesh`` (default: all ranks on the first card); returns (result, mesh)."""
    mesh = mesh or make_mesh(led, tile)
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    res = fn(ds.images, ds.geom, ds.cfg, mesh=mesh, iterations=3, chunk_size=8,
             use_pallas=True, **kw)
    return res, mesh


def assert_same_result(a, b):
    np.testing.assert_array_equal(a.obj_f_centered, b.obj_f_centered)
    np.testing.assert_array_equal(a.pupil, b.pupil)
    for key in ("data_residual", "update_norm"):
        np.testing.assert_array_equal(a.metrics[key], b.metrics[key])


@pytest.mark.parametrize("kw", [dict(), dict(stale_consensus=True),
                                dict(comm_precision="bf16", stale_consensus=True),
                                dict(dtype="complex128")],
                         ids=["fresh", "stale", "bf16-wire-stale", "complex128"])
@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2), (1, 6)])
def test_the_graph_route_is_bitwise_the_host_loop(cuda, monkeypatch, led, tile, kw):
    """Every rank on the one card: the entry point replays one captured
    sweep; with the test-only ``force_host_loop`` it walks the loop. Both
    bitwise, the same launches and counted collectives, and the captured
    schedule's verdict the host loop's. (On a machine with several cards
    ``make_mesh`` spreads the ranks over them: the graph takes the peer
    route, whose signal, wait and pull kernels the host loop, on the copy
    route, does not launch; every other launch count is the same. The
    complex128 state keeps the copy route between cards.)"""
    from fpm_torch.parallel import comm, graph

    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    before = kernels.launch_counts()
    replayed, mesh = sharded_entry(ds, led, tile, **kw)
    run = replayed.replay
    assert run is not None and len(run["enqueue_ms"]) == 3
    mid = kernels.launch_counts()
    per_replay = {k: mid[k] - before[k] for k in mid}
    assert per_replay == {k: 3 * v for k, v in run["launches"].items()}
    verdict = comm.consensus_schedule_check(mesh.schedule)
    monkeypatch.setattr(graph.run_sweeps, "force_host_loop", True)
    walked, host_mesh = sharded_entry(ds, led, tile, **kw)
    assert walked.replay is None
    after = kernels.launch_counts()
    peer = {k for k in after if k.startswith("peer_")}
    assert {k: after[k] - mid[k] for k in after if k not in peer} == {
        k: v for k, v in per_replay.items() if k not in peer}
    assert all(after[k] == mid[k] for k in peer)
    want = ("one card" if len(mesh.cards()) == 1
            else "copy" if kw.get("dtype") == "complex128" else "peer")
    assert run["peer_route"] == want
    assert any(per_replay[k] > 0 for k in peer) is (want == "peer")
    assert_same_result(replayed, walked)
    assert mesh.counts == host_mesh.counts
    walked_verdict = comm.consensus_schedule_check(host_mesh.schedule)
    if want == "peer":      # the peer route's schedule also holds its fork and pulls
        walked_verdict, verdict = ({k: v for k, v in d.items() if not k.endswith("_idx")}
                                   for d in (walked_verdict, verdict))
    assert walked_verdict == verdict
    assert verdict["issued_before_compute"] is bool(kw.get("stale_consensus"))


@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_replays_allocate_nothing(cuda, led, tile):
    """The graph's sweeps write only into buffers made before the capture:
    the caching allocator's count of allocations does not move across
    replays, nor during the capture."""
    from fpm_torch.parallel import graph, led_shard, tile_shard

    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    mesh = make_mesh(led, tile)
    kw = dict(chunk_size=8, use_pallas=True, stale_consensus=True)
    if tile == 1:
        route, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def body(bufs):
            return led_shard._sharded_sweep(mesh, route, opts=opts, bufs=bufs)
    else:
        route, opts, s = tile_shard.prepare_tile_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def body(bufs):
            return tile_shard._tile_sweep(mesh, route, opts=opts, s=s, bufs=bufs)
    run = graph.SweepGraph(mesh, route, body)
    run.replay()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(5):
        run.replay()
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated


@pytest.fixture
def one_process_world(monkeypatch):
    """Starts a one-process ``torch.distributed`` world on localhost whose
    meshes' transport is ``backend`` ("nccl": no other process shares the
    card; "gloo": as where this torch has no NCCL), and destroys it after."""
    import socket

    import torch.distributed as dist

    from fpm_torch.parallel import multihost

    def start(backend):
        if backend == "gloo":
            monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        assert multihost.initialize_from_env(f"127.0.0.1:{port}", 1, 0)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def without_transport(led, tile, card):
    """The ``led × tile`` mesh of one process on ``card``, made while a
    ``torch.distributed`` world is open (where ``make_mesh`` would span it)."""
    from fpm_torch.parallel.mesh import Mesh

    return Mesh([[card] * tile for _ in range(led)])


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_a_process_transport_walks_the_host_loop(cuda, one_process_world, backend):
    """Under torch.distributed (one process here, its collectives over the
    transport's process group) the run is host-walked by rule over gloo,
    and over NCCL replays one captured sweep, its collectives included;
    either bitwise the graph route of the same mesh shape without a
    transport."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    replayed, _ = sharded_entry(ds, 2, 1, stale_consensus=True)
    one_process_world(backend)
    mesh = make_mesh(2, 1)
    assert mesh.transport.backend == backend
    run, _ = sharded_entry(ds, 2, 1, mesh=mesh, stale_consensus=True)
    assert (run.replay is not None) is (backend == "nccl")
    assert_same_result(replayed, run)


@pytest.mark.parametrize("kw", [dict(), dict(comm_precision="bf16", stale_consensus=True)],
                         ids=["fresh", "bf16-wire-stale"])
@pytest.mark.parametrize("led,tile", [(2, 1), (1, 2)])
def test_the_nccl_graph_route_is_bitwise_the_host_loop(cuda, monkeypatch, one_process_world,
                                                       led, tile, kw):
    """A one-process NCCL world, two ranks on the card: the entry point
    replays one captured sweep with the transport's all-gathers in it;
    with the test-only ``force_host_loop`` it walks the loop. Both bitwise
    the mesh without a transport, the same launches, and the counted
    collectives the host loop's and the analytic model's."""
    from fpm_torch.parallel import comm, graph

    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    one_process_world("nccl")
    single, _ = sharded_entry(ds, led, tile, mesh=without_transport(led, tile, cuda), **kw)
    before = kernels.launch_counts()
    replayed, mesh = sharded_entry(ds, led, tile, mesh=make_mesh(led, tile), **kw)
    assert mesh.transport.backend == "nccl"
    assert replayed.replay is not None and len(replayed.replay["enqueue_ms"]) == 3
    mid = kernels.launch_counts()
    monkeypatch.setattr(graph.run_sweeps, "force_host_loop", True)
    walked, host_mesh = sharded_entry(ds, led, tile, mesh=make_mesh(led, tile), **kw)
    assert walked.replay is None
    after = kernels.launch_counts()
    assert {k: after[k] - mid[k] for k in after} == {k: mid[k] - before[k] for k in mid}
    assert_same_result(replayed, walked)
    assert_same_result(replayed, single)
    assert mesh.counts == host_mesh.counts
    cfg, k = ds.cfg, ds.geom.num_leds
    if tile == 1:
        model, hops = comm.led_shard_comm(cfg.n_large, cfg.np_size, k, 8, led), 1
    else:
        model = comm.tile_shard_comm(cfg.n_large, cfg.np_size, k, led, tile, 8)
        hops = -(-cfg.np_size // (cfg.n_large // tile))
    if not kw:
        assert comm.counted_mismatches(mesh.counts, model, sweeps=3, halo_hops=hops) == []


@pytest.mark.parametrize("led,tile", [(2, 1), (1, 2)])
def test_nccl_replays_allocate_nothing_and_never_wait_on_the_card(cuda, one_process_world, led,
                                                                  tile):
    """Under a one-process NCCL world the captured sweep, its all-gathers
    included, writes only into buffers made before the capture: the caching
    allocator's count of allocations does not move across replays; and a
    replay passes under ``torch.cuda.set_sync_debug_mode("error")``."""
    from fpm_torch.parallel import graph, led_shard, tile_shard

    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    one_process_world("nccl")
    mesh = make_mesh(led, tile)
    kw = dict(chunk_size=8, use_pallas=True, stale_consensus=True, comm_precision="bf16")
    if tile == 1:
        route, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def body(bufs):
            return led_shard._sharded_sweep(mesh, route, opts=opts, bufs=bufs)
    else:
        route, opts, s = tile_shard.prepare_tile_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def body(bufs):
            return tile_shard._tile_sweep(mesh, route, opts=opts, s=s, bufs=bufs)
    assert graph.replays(mesh)
    run = graph.SweepGraph(mesh, route, body)
    run.replay()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _ in range(5):
        run.replay()
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated


def test_a_graph_over_several_cards_puts_the_warm_up_back_after_it_ends(cuda):
    """A graph over two cards of this process starts from the state before
    its warm-up on both cards, even where the warm-up's last work on the
    second card (here a late write to its state on its comm lane, behind a
    spin kernel) is still running when the warm-up returns."""
    from fpm_torch.parallel import graph, led_shard

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the ranks of one mesh on different cards")
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    mesh = make_mesh(2, 1)
    route, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh,
                                                chunk_size=8, use_pallas=True)
    before = [t.clone() for t in graph._state(route)]
    second = mesh.devices[1][0]
    assert second != mesh.home

    def body(bufs):
        mets = led_shard._sharded_sweep(mesh, route, opts=opts, bufs=bufs)
        if not bufs.frozen:
            lane = mesh._lane_streams["comm"][second]
            with torch.cuda.device(second), torch.cuda.stream(lane):
                torch.cuda._sleep(100_000_000)              # ~50 ms on the second card
                route.obj[1][0].add_(1.0)
        return mets

    graph.SweepGraph(mesh, route, body)
    for card in (mesh.home, second):
        torch.cuda.synchronize(card)
    for now, was in zip(graph._state(route), before):
        assert torch.equal(now.cpu(), was.cpu())


def test_the_signal_and_wait_kernels_order_two_streams(cuda):
    """``peer_post`` and ``peer_wait`` at epochs 1-3 and chunks 0-3 (both
    parities of a signal): a wait on one stream holds a copy until a post
    on another stream, which runs after a ~20 ms spin, so the copy reads
    what was written before the post; the flag block holds the plain
    versions' words. Across two cards (with two) the same, the flag on one
    card and its waiter on the other."""
    from fpm_torch.parallel import make_mesh

    pairs = [(cuda, cuda)]
    if torch.cuda.device_count() > 1:
        make_mesh(2, 1)                          # peer access between cards 0 and 1
        pairs.append((torch.device("cuda", 0), torch.device("cuda", 1)))
    for poster, waiter in pairs:
        words, mine = kernels.flag_block(poster), kernels.flag_block(waiter)
        plain = kernels.flag_block("cpu")
        a, b = torch.cuda.Stream(poster), torch.cuda.Stream(waiter)
        src = torch.zeros(1 << 20, device=poster)
        dst = torch.empty(1 << 20, device=waiter)
        for epoch in range(1, 4):
            for w in (words, mine):
                kernels.peer_epoch(w)
            kernels.peer_epoch_plain(plain)
            torch.cuda.synchronize(poster)
            torch.cuda.synchronize(waiter)
            for chunk in range(4):
                with torch.cuda.device(poster), torch.cuda.stream(a):
                    torch.cuda._sleep(40_000_000)
                    src.fill_(10.0 * epoch + chunk)
                    kernels.peer_post(words, chunk % 2, chunk)
                with torch.cuda.device(waiter), torch.cuda.stream(b):
                    kernels.peer_wait([(words, chunk % 2, chunk)], mine)
                    dst.copy_(src)
                kernels.peer_post_plain(plain, chunk % 2, chunk)
                torch.cuda.synchronize(poster)
                torch.cuda.synchronize(waiter)
                assert torch.all(dst == 10.0 * epoch + chunk)
                assert torch.equal(words.cpu(), plain)


def test_a_wait_met_at_launch_returns_for_one_flag_and_for_32(cuda):
    """A wait on flags already posted (the chunk awaited, or an earlier
    one: a flag that holds a later post meets it) ends without a post
    after it: one launch a wait of up to 32 flags."""
    words = kernels.flag_block(cuda)
    kernels.peer_epoch(words)
    for slot in range(32):
        kernels.peer_post(words, slot, 5)
    for n in (1, 32):
        before = kernels.peer_wait.launches
        kernels.peer_wait([(words, slot, 5) for slot in range(n)], words)
        kernels.peer_wait([(words, slot, 2) for slot in range(n)], words)
        torch.cuda.synchronize()
        assert kernels.peer_wait.launches == before + 2


def test_a_wait_on_32_flags_woken_by_later_posts_orders_its_stream_after_them(cuda):
    """One wait on 32 flags, enqueued on stream B before stream A posts
    them, each post after a ~0.1 ms spin and a write of its own slice (3
    rounds, a chunk each): the copy that follows the wait on B reads every
    slice as written before its post."""
    words = kernels.flag_block(cuda)
    kernels.peer_epoch(words)
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    src = torch.zeros(32, 1 << 15, device=cuda)
    dst = torch.empty_like(src)
    for stream in (a, b):
        stream.wait_stream(torch.cuda.current_stream())
    for chunk in range(3):
        with torch.cuda.stream(b):
            kernels.peer_wait([(words, slot, chunk) for slot in range(32)], words)
            dst.copy_(src)
        with torch.cuda.stream(a):
            for slot in range(32):
                torch.cuda._sleep(200_000)
                src[slot].fill_(100.0 * chunk + slot)
                kernels.peer_post(words, slot, chunk)
        torch.cuda.synchronize()
        want = 100.0 * chunk + torch.arange(32.0, device=cuda)[:, None]
        assert torch.equal(dst, want.expand_as(dst))


@pytest.fixture
def two_cards(cuda):
    """Cards 0 and 1 with peer access both ways; skips under two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a flag and the rows it guards on one, the "
                    "reader on the other")
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    kernels.enable_peer_access(a, b)
    kernels.enable_peer_access(b, a)
    return a, b


# Pulls held against peer_pull_plain: (planes, rows, cols) of the halo, the
# rows of the tile it is taken from, the offset of the tile in its buffer
# (in floats), and the path the plan takes.
PULLS = {"mono (2,2)": ((2, 90, 360), 180, 0, "vector"),
         "dogStomach (2,2)": ((2, 200, 600), 300, 0, "vector"),
         "odd columns": ((2, 90, 361), 180, 0, "scalar"),
         "a view one float in": ((2, 90, 360), 180, 1, "scalar"),
         "one row": ((1, 1, 4), 2, 0, "vector"),
         "rows past a lane's loads": ((2, 3, 4 * 32 * 8 * 2 + 4), 5, 0, "vector"),
         "odd rows past a lane's loads": ((3, 3, 32 * 8 * 2 + 1), 4, 0, "scalar")}
# Plans forced on the main path's halos beside the planned one: the vector
# and scalar paths at 32 and 1024 threads a block.
FORCED = {"vector 32": ("vector", 32), "vector 1024": ("vector", 1024),
          "scalar 32": ("scalar", 32), "scalar 1024": ("scalar", 1024)}


def forced_plan(name, planes, rows):
    path, threads = FORCED[name]
    return kernels.PullPlan(path, -(-rows // (threads // 32)) * planes, threads)


@pytest.mark.parametrize("source", ["this card", "a peer"])
@pytest.mark.parametrize("forced", [None, *FORCED])
@pytest.mark.parametrize("case", list(PULLS))
def test_the_pull_is_bitwise_its_plain_version_on_every_path(cuda, monkeypatch, case, forced,
                                                             source):
    """P4 on the path its plan takes and, on the main path's halos, on
    forced plans (the vector and scalar paths at 32 and 1024 threads):
    every element as ``peer_pull_plain`` copies it, from a tile on this
    card and from one on a peer card (two cards)."""
    (planes, rows, cols), tile_rows, offset, path = PULLS[case]
    if source == "a peer" and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the tile on a peer card")
    if forced and case not in ("mono (2,2)", "dogStomach (2,2)"):
        pytest.skip("the forced plans are for the main path's halos")
    home = torch.device("cuda", 0)
    sdev = torch.device("cuda", 1 if source == "a peer" else 0)
    if sdev != home:
        kernels.enable_peer_access(home, sdev)
    g = torch.Generator().manual_seed(planes * rows + cols + offset)
    buf = torch.randn(offset + planes * tile_rows * cols, generator=g).to(sdev)
    src = buf[offset:].view(planes, tile_rows, cols)[:, :rows]
    dst = torch.full((planes, rows, cols), float("nan"), device=home)
    plan = kernels.pull_plan_of(dst, src)
    assert plan.path == path
    if forced:
        monkeypatch.setattr(kernels.peer_pull, "force_plan", forced_plan(forced, planes, rows))
    before = kernels.peer_pull.launches
    kernels.peer_pull(dst, src)
    torch.cuda.synchronize(home)
    assert kernels.peer_pull.launches == before + 1
    want = torch.empty(planes, rows, cols)
    kernels.peer_pull_plain(want, src.cpu())
    assert torch.equal(dst.cpu(), want)


@pytest.mark.parametrize("case", ["vector on a view one float in", "vector on odd columns",
                                  "a grid short of the rows", "threads not whole warps",
                                  "threads past 1024"])
def test_a_pull_plan_the_operands_do_not_allow_raises(cuda, monkeypatch, case):
    """The C entry checks the plan again: a path the rows do not allow, or
    a grid that does not cover them or that no block can hold, is refused,
    and nothing is launched."""
    cols = 361 if case == "vector on odd columns" else 360
    buf = torch.zeros(1 + 2 * 180 * cols, device=cuda)
    src = buf[1 if "one float in" in case else 0:][:2 * 180 * cols].view(2, 180, cols)[:, :90]
    dst = torch.empty((2, 90, cols), device=cuda)
    P = kernels.PullPlan
    plan = {"vector on a view one float in": P("vector", 90, 64),
            "vector on odd columns": P("vector", 90, 64),
            "a grid short of the rows": P("vector", 88, 64),
            "threads not whole warps": P("vector", 90, 48),
            "threads past 1024": P("vector", 2 * 2, 2048)}[case]
    monkeypatch.setattr(kernels.peer_pull, "force_plan", plan)
    before = kernels.peer_pull.launches
    with pytest.raises(RuntimeError, match="peer_pull"):
        kernels.peer_pull(dst, src)
    assert kernels.peer_pull.launches == before


@pytest.mark.parametrize("path", ["planned", "scalar"])
def test_a_post_orders_every_write_before_it_for_a_reader_on_another_card(two_cards, monkeypatch,
                                                                          path):
    """The ordering litmus across cards: card A spins, writes an 8 MB buffer
    (a pattern plus the round's number) and posts; card B waits on A's flag
    on its own stream and pulls A's buffer in place. Every element read is
    the round's, over 48 rounds: four times epochs 1-3 (each sweep's epoch
    bumped on both cards, 12 in all) and chunks 0-3 (both parities of a
    signal), with spins of 0 to ~2 ms; each round waits for a post no
    earlier round made, since a flag only grows."""
    a, b = two_cards
    words, mine = kernels.flag_block(a), kernels.flag_block(b)
    pattern = torch.arange(2 * 1024 * 1024, dtype=torch.float32, device=a).view(2, 1024, 1024)
    src, dst = torch.empty_like(pattern), torch.empty(pattern.shape, device=b)
    want = pattern.to(b)
    sa, sb = torch.cuda.Stream(a), torch.cuda.Stream(b)
    if path == "scalar":
        monkeypatch.setattr(kernels.peer_pull, "force_plan",
                            kernels.PullPlan("scalar", 2 * 512, 64))
    wrong, rounds = 0, 0
    for epoch in range(1, 13):
        for w in (words, mine):
            kernels.peer_epoch(w)
        for d in (a, b):
            torch.cuda.synchronize(d)
        for chunk in range(4):
            spin = (0, 100_000, 1_000_000, 4_000_000)[(epoch + chunk) % 4]
            value = float(100 * epoch + chunk)
            with torch.cuda.device(a), torch.cuda.stream(sa):
                if spin:
                    torch.cuda._sleep(spin)
                torch.add(pattern, value, out=src)
                kernels.peer_post(words, chunk % 2, chunk)
            with torch.cuda.device(b), torch.cuda.stream(sb):
                kernels.peer_wait([(words, chunk % 2, chunk)], mine)
                kernels.peer_pull(dst, src)
            for d in (a, b):
                torch.cuda.synchronize(d)
            wrong += int((dst != want + value).sum())
            rounds += 1
    assert rounds == 48 and wrong == 0


# The stale-epoch litmus: its rounds, and the spins (torch.cuda._sleep
# cycles, 0 to ~0.5 ms at ≤ 2 GHz) before each round's post, in turn.
EPOCH_ROUNDS = 256
EPOCH_SPINS = (0, 2_000, 20_000, 200_000, 1_000_000)


@pytest.mark.parametrize("cards", ["one card", "0 to 1", "1 to 0"])
def test_a_wait_never_reads_the_last_sweeps_epoch(cuda, cards):
    """The stale-epoch litmus, EPOCH_ROUNDS sweeps of one chunk: the last
    sweep's flag is already posted when a sweep opens with ``peer_epoch``
    on stream A of the waiting card; stream B waits on A's event, then
    (``peer_wait``) on chunk 0 of the new sweep, then pulls the poster's
    buffer; stream C, on the posting card, waits on A's event too, bumps
    that card's epoch (two cards), spins, fills the buffer with the
    round's number and posts. A wait that read the last sweep's epoch
    would be met by the last sweep's flag and pull the last fill: no round
    may. The next sweep opens after B and C end, as the mesh's join
    orders it. On one card, and with the post on card 0 and the epoch and
    the wait on card 1, and the other way."""
    if cards == "one card":
        poster = waiter = torch.device("cuda", 0)
    else:
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two CUDA devices: the post on one, the epoch and the wait on "
                        "the other")
        p, w = (0, 1) if cards == "0 to 1" else (1, 0)
        poster, waiter = torch.device("cuda", p), torch.device("cuda", w)
        kernels.enable_peer_access(waiter, poster)
    home = kernels.flag_block(poster)
    mine = home if poster == waiter else kernels.flag_block(waiter)
    blocks = [home] if mine is home else [home, mine]
    a, b, c = torch.cuda.Stream(waiter), torch.cuda.Stream(waiter), torch.cuda.Stream(poster)
    src = torch.zeros((1, 32, 1024), device=poster)
    out = torch.zeros((EPOCH_ROUNDS, 1, 32, 1024), device=waiter)
    for block in blocks:                        # the sweep before the first: chunk 0 posted
        kernels.peer_epoch(block)
    kernels.peer_post(home, 0, 0)
    for d in {poster, waiter}:
        torch.cuda.synchronize(d)
    before = kernels.peer_epoch.launches
    for k in range(EPOCH_ROUNDS):
        with torch.cuda.device(waiter), torch.cuda.stream(a):
            a.wait_stream(b)
            a.wait_stream(c)
            kernels.peer_epoch(mine)
            opened = torch.cuda.Event()
            opened.record(a)
        c.wait_event(opened)
        b.wait_event(opened)
        with torch.cuda.device(poster), torch.cuda.stream(c):
            if mine is not home:
                kernels.peer_epoch(home)
            spin = EPOCH_SPINS[k % len(EPOCH_SPINS)]
            if spin:
                torch.cuda._sleep(spin)
            src.fill_(float(k + 1))
            kernels.peer_post(home, 0, 0)
        with torch.cuda.device(waiter), torch.cuda.stream(b):
            kernels.peer_wait([(home, 0, 0)], mine)
            kernels.peer_pull(out[k], src)
    for d in {poster, waiter}:
        torch.cuda.synchronize(d)
    want = torch.arange(1, EPOCH_ROUNDS + 1, dtype=torch.float32, device=waiter)
    wrong = int((out != want[:, None, None, None]).any(dim=(1, 2, 3)).sum())
    assert wrong == 0
    assert kernels.peer_epoch.launches == before + EPOCH_ROUNDS * len(blocks)
    assert all(int(block[0]) == EPOCH_ROUNDS + 1 for block in blocks)
    assert int(home[1]) == ((EPOCH_ROUNDS + 1) << 32) | 1


REPLAYS = 5


@pytest.mark.parametrize("route", ["streams", "peer"])
@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_each_replay_bumps_every_cards_epoch_once_and_every_flag_carries_it(
        cuda, monkeypatch, led, tile, route):
    """A stale sweep on a route of flags, captured and replayed REPLAYS
    times: the one card's streams ordered by flags (``streams``, the
    test-only ``force_flags``) or a rank a card over the cards there are
    (``peer``, two cards or more). Each card's word 0 is then the
    warm-up's one bump and one a replay, and the high word of every flag
    posted is that epoch."""
    from fpm_torch.parallel import graph, led_shard, peer_route, tile_shard

    n = torch.cuda.device_count()
    if route == "peer" and n < 2:
        pytest.skip("needs two CUDA devices: the ranks of one mesh on different cards")
    if route == "streams":
        monkeypatch.setattr(peer_route, "force_flags", True)
    devices = [torch.device("cuda", i % n if route == "peer" else 0) for i in range(led * tile)]
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    mesh = make_mesh(led, tile, devices=devices)
    kw = dict(chunk_size=8, use_pallas=True, stale_consensus=True)
    if tile == 1:
        prep, opts = led_shard.prepare_led_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def body(bufs):
            return led_shard._sharded_sweep(mesh, prep, opts=opts, bufs=bufs)
    else:
        prep, opts, s = tile_shard.prepare_tile_sharded(ds.images, ds.geom, ds.cfg, mesh, **kw)

        def body(bufs):
            return tile_shard._tile_sweep(mesh, prep, opts=opts, s=s, bufs=bufs)
    assert peer_route(mesh) == route
    run = graph.SweepGraph(mesh, prep, body)
    cards = [card for card, _ in mesh.cards()]
    assert run.launches["peer_epoch"] == len(cards) and run.launches["peer_post"] > 0
    for _ in range(REPLAYS):
        run.replay()
    for card in cards:
        torch.cuda.synchronize(card)
    assert len(mesh._flags) == len(cards)
    for block in mesh._flags:
        words = block.cpu()
        assert int(words[0]) == 1 + REPLAYS
        posted = words[1:][words[1:] != 0]
        assert posted.numel() > 0 and torch.all(posted >> 32 == 1 + REPLAYS)


@pytest.mark.parametrize("kw", [dict(), dict(stale_consensus=True),
                                dict(comm_precision="bf16", stale_consensus=True)],
                         ids=["fresh", "stale", "bf16-wire-stale"])
@pytest.mark.parametrize("led,tile", [(2, 1), (1, 2)])
def test_the_peer_route_over_two_cards_is_bitwise_the_copy_route_and_the_host_loop(
        cuda, monkeypatch, led, tile, kw):
    """A rank on each of two cards: the graph on the peer route (payloads
    read in place, flags between the cards; no event edge between them in
    the chunk loop), the graph on the copy route (the same mesh with its
    peer access taken back, test-only), and the host loop, bitwise."""
    from fpm_torch.parallel import graph

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the ranks of one mesh on different cards")
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    devices = [torch.device("cuda", i) for i in range(2)]
    peer, mesh = sharded_entry(ds, led, tile, mesh=make_mesh(led, tile, devices=devices), **kw)
    assert mesh.peer_access and peer.replay["peer_route"] == "peer"
    assert peer.replay["card_edges"]["chunk_loop"] == 0
    assert peer.replay["card_edges"]["total"] == 2
    assert peer.replay["launches"]["peer_wait"] > 0
    copy_mesh = make_mesh(led, tile, devices=devices)
    copy_mesh.peer_access = False
    copied, _ = sharded_entry(ds, led, tile, mesh=copy_mesh, **kw)
    assert copied.replay["peer_route"] == "copy"
    assert copied.replay["card_edges"]["chunk_loop"] > 0
    monkeypatch.setattr(graph.run_sweeps, "force_host_loop", True)
    walked, _ = sharded_entry(ds, led, tile, mesh=make_mesh(led, tile, devices=devices), **kw)
    assert_same_result(peer, copied)
    assert_same_result(peer, walked)


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("led,tile", [(4, 1), (2, 2)])
def test_flags_between_the_streams_of_one_card_are_bitwise_the_default(cuda, monkeypatch, led,
                                                                      tile, stale):
    """The test-only ``peer_route.force_flags``: every rank on one card, the
    order between its streams kept by flags and the halo pulled, as the
    peer route does between cards; bitwise the default route, and every
    kernel of the route launched."""
    from fpm_torch.parallel import peer_route

    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    devices = [torch.device("cuda", 0)] * (led * tile)
    default, _ = sharded_entry(ds, led, tile, mesh=make_mesh(led, tile, devices=devices),
                               stale_consensus=stale)
    monkeypatch.setattr(peer_route, "force_flags", True)
    flagged, _ = sharded_entry(ds, led, tile, mesh=make_mesh(led, tile, devices=devices),
                               stale_consensus=stale)
    run = flagged.replay
    assert default.replay["peer_route"] == "one card" and run["peer_route"] == "streams"
    assert all(run["launches"][k] > 0 for k in ("peer_epoch", "peer_post", "peer_wait"))
    assert (run["launches"]["peer_pull"] > 0) is (tile > 1)
    assert_same_result(flagged, default)


def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """An operation a capture refuses (a synchronisation, here at the end of
    the captured sweep) makes the run raise: nothing carries on with the
    host loop. (Last in this file: the failed capture is left behind.)"""
    from fpm_torch.parallel import mesh as mesh_module

    end_sweep = mesh_module.Mesh.end_sweep
    sweeps = []

    def refused(self, *grids, **kw):
        end_sweep(self, *grids, **kw)
        sweeps.append(torch.cuda.is_current_stream_capturing())
        if sweeps[-1]:
            torch.cuda.synchronize()

    monkeypatch.setattr(mesh_module.Mesh, "end_sweep", refused)
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    with pytest.raises(RuntimeError):
        sharded_entry(ds, 2, 1)
    # The warm-up, then the capture that raised: no sweep of the host loop.
    assert sweeps == [False, True]
