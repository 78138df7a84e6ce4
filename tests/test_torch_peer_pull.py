"""The launch of the peer route's halo pull (``kernels.pull_plan``,
``pull_plan_of``) and the checks of its wrappers, on the CPU.

The pull (``csrc/epry_peer.cu`` ``fpm_peer_pull``) copies planes × rows
runs of cols floats from a peer card's state into a contiguous buffer, a
warp a row in a grid of (row blocks, planes). Its plan is a plain function
of the shape, the strides and the alignment, which the C entry checks
again: the vector path (float4) where every row is 16-byte chunks starting
on 16 bytes (cols % 4 == 0, strides % 4 == 0, both pointers on 16 bytes),
the scalar path otherwise. Held here at
the main path's halos (mono (2,2): 2 × 90 rows of 360 floats; dogStomach
(2,2): 2 × 200 of 600), for unaligned views and odd columns, and against
the pulls a sharded sweep on CPU "cards" makes; the kernels themselves are
held bitwise against ``peer_pull_plain`` on the card
(tests/test_torch_cuda.py).
"""

import pytest
import torch

from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.ops import kernels
from fpm_torch.parallel import graph, make_mesh, tile_shard
from fpm_torch.parallel.mesh import peer_route

# (planes, rows, cols) of the halo and the (planes, tile rows, cols) tile
# it is pulled from, as tile_shard's forward halo takes it.
HALOS = {"mono (2,2)": ((2, 90, 360), (2, 180, 360)),
         "dogStomach (2,2)": ((2, 200, 600), (2, 300, 600))}


def warp_rows(plan, planes, rows):
    """The rows the grid's warps take, (plane, row) each, in grid order:
    (row blocks, planes) of plan.threads / 32 warps, a warp a row."""
    warps = plan.threads // 32
    per_plane = plan.blocks // planes
    return [(p, b * warps + w) for p in range(planes) for b in range(per_plane)
            for w in range(warps) if b * warps + w < rows]


@pytest.mark.parametrize("halo", list(HALOS))
def test_the_main_path_halos_take_the_vector_path_a_warp_a_row(halo):
    (planes, rows, cols), tile = HALOS[halo]
    src = torch.zeros(tile)[:, :rows]
    plan = kernels.pull_plan(planes, rows, cols, src.stride(0), src.stride(1), aligned=True)
    assert plan.path == "vector" and plan.threads == kernels.PULL_THREADS
    assert plan.threads % 32 == 0 and plan.blocks % planes == 0
    # Every row of every plane is one warp's, once, in one grid.
    assert warp_rows(plan, planes, rows) == [(p, r) for p in range(planes) for r in range(rows)]
    assert (plan.blocks // planes - 1) * plan.threads // 32 < rows


@pytest.mark.parametrize("aligned", [True, False], ids=["vector", "scalar"])
@pytest.mark.parametrize("halo", list(HALOS))
def test_both_paths_take_the_halo_a_warp_a_row_in_blocks_of_pull_threads(halo, aligned):
    """Where the pointers are on 16 bytes the vector path, else the scalar
    one: the same grid of PULL_THREADS-thread blocks, a warp each row, from
    a peer's memory as from this card's."""
    (planes, rows, cols), tile = HALOS[halo]
    plan = kernels.pull_plan(planes, rows, cols, tile[1] * cols, cols, aligned=aligned)
    assert plan.path == ("vector" if aligned else "scalar")
    assert plan.threads == kernels.PULL_THREADS
    assert warp_rows(plan, planes, rows) == [(p, r) for p in range(planes) for r in range(rows)]


@pytest.mark.parametrize("halo", list(HALOS))
def test_the_wrapper_plans_the_vector_path_for_the_halo_view_of_a_tile(halo):
    (planes, rows, cols), tile = HALOS[halo]
    dst, src = torch.empty(planes, rows, cols), torch.randn(tile)[:, :rows]
    plan = kernels.pull_plan_of(dst, src)
    assert plan == kernels.pull_plan(planes, rows, cols, src.stride(0), src.stride(1),
                                     aligned=True)
    assert plan.path == "vector"


@pytest.mark.parametrize("case", ["odd columns", "view one float in", "row stride odd",
                                  "plane stride odd", "dst one float in"])
def test_unaligned_views_and_odd_columns_take_the_scalar_path(case):
    """Rows that are not 16-byte chunks on 16 bytes: the scalar path, a warp
    a row, as many row blocks as the rows need on every plane."""
    planes, rows, cols = 2, 90, 361 if case == "odd columns" else 360
    buf = torch.zeros(planes * 181 * 361 + 8)
    if case == "view one float in":
        src = buf[1:1 + planes * 180 * cols].view(planes, 180, cols)[:, :rows]
    elif case == "row stride odd":
        src = buf[:planes * 180 * 361].view(planes, 180, 361)[:, :rows, :cols]
    elif case == "plane stride odd":
        src = buf[:planes * 181 * cols + 1].as_strided((planes, rows, cols),
                                                        (181 * cols + 1, cols, 1))
    else:
        src = buf[:planes * 180 * cols].view(planes, 180, cols)[:, :rows]
    dst_buf = torch.zeros(planes * rows * cols + 1)
    dst = (dst_buf[1:] if case == "dst one float in" else dst_buf[:-1]).view(planes, rows, cols)
    plan = kernels.pull_plan_of(dst, src)
    warps = kernels.PULL_THREADS // 32
    assert plan == kernels.PullPlan("scalar", -(-rows // warps) * planes, kernels.PULL_THREADS)
    kernels.peer_pull(dst, src)
    assert torch.equal(dst, src)


@pytest.mark.parametrize("cols", [4, 360, 600, 20000])
def test_rows_of_any_length_take_one_warp(cols):
    """A warp takes its row whatever its length (a lane holds up to eight
    float4 of it at a time, csrc/epry_peer.cu ``kPerLane``): the grid the
    same."""
    plan = kernels.pull_plan(3, 5, cols, 5 * cols, cols, aligned=True)
    assert plan == kernels.PullPlan("vector", 3 * -(-5 // (kernels.PULL_THREADS // 32)),
                                    kernels.PULL_THREADS)


@pytest.mark.parametrize("planes,rows", [(1, 1), (1, 3), (2, 1), (3, 2), (2, 90)])
def test_the_grid_has_a_warp_for_every_row_and_no_idle_block(planes, rows):
    plan = kernels.pull_plan(planes, rows, 8, rows * 8, 8, aligned=True)
    assert warp_rows(plan, planes, rows) == [(p, r) for p in range(planes) for r in range(rows)]
    assert plan.blocks == planes * -(-rows // (plan.threads // 32))


def test_a_forced_plan_is_the_wrappers_until_taken_back(monkeypatch):
    dst, src = torch.empty(2, 90, 360), torch.randn(2, 180, 360)[:, :90]
    forced = kernels.PullPlan("scalar", 24, 256)
    monkeypatch.setattr(kernels.peer_pull, "force_plan", forced)
    assert kernels.pull_plan_of(dst, src) == forced
    monkeypatch.undo()
    assert kernels.pull_plan_of(dst, src).path == "vector"


REFUSED = {
    "shapes differ": lambda: (torch.empty(2, 90, 360), torch.zeros(2, 91, 360)),
    "float64": lambda: (torch.empty(2, 90, 360, dtype=torch.float64),
                        torch.zeros(2, 90, 360, dtype=torch.float64)),
    "two dimensions": lambda: (torch.empty(90, 360), torch.zeros(90, 360)),
    "dst not contiguous": lambda: (torch.empty(2, 90, 720)[:, :, :360], torch.zeros(2, 90, 360)),
    "src strided along its rows": lambda: (torch.empty(2, 90, 360),
                                           torch.zeros(2, 90, 720)[:, :, ::2]),
    "too many planes": lambda: (torch.empty(65536, 1, 4), torch.zeros(65536, 1, 4)),
    "src where its card cannot read": lambda: (torch.empty(2, 90, 360),
                                               torch.zeros(2, 90, 360, device="meta")),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_pull_refuses_what_its_kernel_does_not_take(case):
    dst, src = REFUSED[case]()
    with pytest.raises(ValueError, match="peer_pull"):
        kernels.pull_operands(dst, src)


def test_the_pull_takes_a_peers_halo_view():
    dst, src = torch.empty(2, 90, 360), torch.randn(2, 180, 360)[:, :90]
    kernels.pull_operands(dst, src)


@pytest.mark.parametrize("slot,chunk", [(-1, 0), (kernels.FLAG_SIGNALS, 0), (0, -1)])
def test_the_post_refuses_a_signal_or_chunk_out_of_range(slot, chunk):
    with pytest.raises(ValueError, match="peer_post"):
        kernels.peer_post(kernels.flag_block("cpu"), slot, chunk)


def sweep(ds, devices, stale, sweeps=2):
    """``sweeps`` tile-sharded sweeps (2,2) over buffers made once (the
    sweep a card captures) on ``devices``: the metrics of each and the
    final state."""
    mesh = make_mesh(2, 2, devices=devices)
    route, opts, s = tile_shard.prepare_tile_sharded(
        ds.images, ds.geom, ds.cfg, mesh, use_pallas=True, dtype="complex64", chunk_size=8,
        stale_consensus=stale)
    bufs = graph.SweepBuffers()
    mets = [tile_shard._tile_sweep(mesh, route, opts=opts, s=s, bufs=bufs).clone()
            for _ in range(sweeps)]
    return mesh, mets, route.final_state(mesh, tile_shard._fetch(mesh, route.obj))


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_the_pulls_of_a_sweep_on_cpu_cards_are_planned_on_the_vector_path(monkeypatch, stale):
    """A tile-sharded sweep over buffers on four CPU "cards" (the peer
    route, as on four cards with peer access): every halo it pulls is a
    view that the plan sends down the vector path on a card, a warp for
    each of its rows, and the sweeps are bitwise the same mesh on one
    card."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=5)
    plans = []
    pull = kernels.peer_pull

    def recording(dst, src, **kw):
        plans.append((kernels.pull_plan(*dst.shape, src.stride(0), src.stride(1),
                                        aligned=kernels._aligned([dst, src])),
                      tuple(dst.shape)))
        return pull(dst, src, **kw)

    monkeypatch.setattr(kernels, "peer_pull", recording)
    mesh, mets, state = sweep(ds, [torch.device("cpu", i) for i in range(4)], stale)
    monkeypatch.undo()
    assert peer_route(mesh) == "peer" and plans
    for plan, (planes, rows, cols) in plans:
        assert plan.path == "vector"
        assert warp_rows(plan, planes, rows) == [(p, r) for p in range(planes)
                                                 for r in range(rows)]
    _, one_mets, one_state = sweep(ds, ["cpu"] * 4, stale)
    assert all(torch.equal(a, b) for a, b in zip(mets, one_mets))
    for a, b in zip(state, one_state):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
