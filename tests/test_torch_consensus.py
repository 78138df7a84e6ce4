"""The consensus of the sharded sweeps' chunks (``ops.kernels.consensus_*``)
on the CPU: the plain versions of the consensus kernels against the op
sequence the sweeps ran before they had them, written out here with the
mesh's own collectives (``Mesh.psum``, ``pmax``, ``ppermute`` on CPU ranks)
and the eager ops of the apply; the wrappers, which take the plain versions
for CPU tensors; ``Mesh.collect``; and whole sharded runs at Np 16 against
the SHA-256 digests of the same runs before the consensus kernels existed.
Every comparison is bitwise: the plain versions make the same f32 (or
complex) operations in the same order. Inputs from a seed with NumPy, small
shapes (NL 48, Np 16, bbox 8). The card's kernels are held against these
plain versions in tests/test_torch_cuda.py.
"""

import hashlib

import numpy as np
import pytest
import torch

from fpm_torch import parallel as tpar
from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.ops import kernels

NL, NP, B, LO = 48, 16, 8, 4
SCALE = 0.75


def rng(seed):
    return np.random.default_rng(seed)


def planes(r, *shape, scale=1.0):
    return torch.from_numpy((r.standard_normal((2, *shape)) * scale).astype(np.float32))


def cplx(r, *shape, dtype=torch.complex64, scale=1.0):
    z = r.standard_normal(shape) + 1j * r.standard_normal(shape)
    return torch.from_numpy(z * scale).to(dtype)


def cpu_mesh(led, tile):
    return tpar.make_mesh(led, tile, devices=["cpu"] * (led * tile))


def as_grid(mesh, fn):
    return mesh.grid(fn)


def parent_pupil_step(pc, v_full, omax):
    """PlanesRoute.pupil_step of the parent: the window of the padded
    numerator, a complex division by the real max."""
    vw = v_full[..., LO:LO + B, LO:LO + B]
    step = torch.complex(pc[0], pc[1]) + SCALE * torch.complex(vw[0], vw[1]) / omax
    return torch.stack([step.real, step.imag])


def pad(v):
    far = NP - LO - B
    return torch.nn.functional.pad(v, (LO, far, LO, far))


def equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.parametrize("first", [True, False], ids=["first-chunk", "later-chunk"])
@pytest.mark.parametrize("wire", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("led", [1, 2, 4, 8])
def test_led_plain_is_the_parent_op_sequence(led, wire, first):
    """LED axis, kernel route with complex64 state: the parent's psums
    (the pupil payload padded to Np×Np), ``o + d``, max|O| of the complex
    spectrum, the windowed pupil step and ``acc + stack(metrics)``."""
    r = rng(led)
    o, pc = planes(r, NL, NL, scale=10), planes(r, B, B)
    ds = [planes(r, NL, NL, scale=0.1) for _ in range(led)]
    vs = [planes(r, B, B, scale=0.1) for _ in range(led)]
    mets = [torch.from_numpy(np.abs(r.standard_normal(2)).astype(np.float32)) for _ in range(led)]
    acc = None if first else torch.from_numpy(np.abs(r.standard_normal(2)).astype(np.float32))

    mesh = cpu_mesh(led, 1)
    d = mesh.local(mesh.psum(as_grid(mesh, lambda li, ti: ds[li]), "led", wire))
    v = mesh.local(mesh.psum(as_grid(mesh, lambda li, ti: pad(vs[li])), "led", wire))
    m = [mesh.local(mesh.psum(as_grid(mesh, lambda li, ti: mets[li][i]), "led")) for i in (0, 1)]
    want_o = o + d
    want_max = torch.max(torch.abs(torch.complex(want_o[0], want_o[1])))
    want_pc = parent_pupil_step(pc, v, want_max)
    want_acc = (0 if acc is None else acc) + torch.stack(m)

    got = kernels.consensus_led_plain(o, pc, ds, vs, [x[0] for x in mets], [x[1] for x in mets],
                                      acc, wire=wire, scale=SCALE)
    for g, w in zip(got, (want_o, want_pc, want_max, want_acc)):
        assert equal(g, w)
    wrapped = kernels.consensus_led(o, pc, ds, vs, [x[0] for x in mets], [x[1] for x in mets],
                                    acc, wire=wire, scale=SCALE)
    assert all(equal(a, b) for a, b in zip(wrapped, got))


def test_led_plain_on_the_complex_route_is_the_parent_op_sequence():
    """The eager route (complex payloads and state): ``o + d``,
    ``max(|o|)``, ``p + scale·v / max``; no metrics kept on this card."""
    r = rng(11)
    o, p = cplx(r, NL, NL, scale=10), cplx(r, NP, NP)
    ds = [cplx(r, NL, NL, scale=0.1) for _ in range(3)]
    vs = [cplx(r, NP, NP, scale=0.1) for _ in range(3)]
    mesh = cpu_mesh(3, 1)
    d = mesh.local(mesh.psum(as_grid(mesh, lambda li, ti: ds[li]), "led"))
    v = mesh.local(mesh.psum(as_grid(mesh, lambda li, ti: vs[li]), "led"))
    want_o = o + d
    want_max = torch.max(torch.abs(want_o))
    want_p = p + SCALE * v / want_max
    got_o, got_p, got_max, acc = kernels.consensus_led_plain(o, p, ds, vs, scale=SCALE,
                                                             metrics=False)
    assert equal(got_o, want_o) and equal(got_p, want_p) and equal(got_max, want_max)
    assert acc is None


def hops_of(s):
    return [(j, lo, min(s, NP - lo)) for j, lo in enumerate(range(0, NP, s), start=1)]


@pytest.mark.parametrize("wire", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("led,tile", [(1, 2), (2, 2), (4, 2), (8, 2), (1, 4), (2, 4)])
def test_tile_plain_is_the_parent_op_sequence(led, tile, wire):
    """Tile axis, kernel route: per tile the psum of the extended block over
    ``led``, the reverse halo (each hop's slab of tile i−j's psum, on the
    wire and back, added to the first rows), ``o + d_local`` and its max;
    the pmax over ``tile``; the (led, tile) pupil psum, the step and the
    metrics. Tile 2 of NL 48: one hop; tile 4 (12 rows < Np 16): two."""
    s = NL // tile
    hops = hops_of(s)
    assert len(hops) == (1 if tile == 2 else 2)
    r = rng(led * 10 + tile)
    objs = [planes(r, s, NL, scale=10) for _ in range(tile)]
    pay = {(li, ti): planes(r, s + NP, NL, scale=0.1) for li in range(led) for ti in range(tile)}
    vs = {k: planes(r, B, B, scale=0.1) for k in pay}
    mets = {k: torch.from_numpy(np.abs(r.standard_normal(2)).astype(np.float32)) for k in pay}
    pc = planes(r, B, B)
    acc = torch.from_numpy(np.abs(r.standard_normal(2)).astype(np.float32))

    mesh = cpu_mesh(led, tile)
    d_ext = mesh.psum(as_grid(mesh, lambda li, ti: pay[(li, ti)]), "led", wire)
    backs = []
    for j, lo, rows in hops:
        slab = mesh.map(lambda d: d[..., s + lo:s + lo + rows, :], d_ext)
        bwd = [(i, (i + j) % tile) for i in range(tile)]
        backs.append((rows, mesh.ppermute(slab, "tile", bwd, prepare=None if wire is None
                                          else lambda x: x.to(wire))))
    want_o, local = {}, mesh.grid(lambda li, ti: None)
    for li, ti in mesh.local_ranks:
        d_local = d_ext[li][ti][..., :s, :]
        for rows, back in backs:
            b = back[li][ti] if wire is None else back[li][ti].float()
            d_local = torch.cat([d_local[..., :rows, :] + b, d_local[..., rows:, :]], dim=-2)
        o = objs[ti] + d_local
        want_o[ti] = o
        local[li][ti] = torch.max(torch.abs(torch.complex(o[0], o[1])))
    omax = mesh.local(mesh.pmax(local, "tile"))
    v = mesh.local(mesh.psum(as_grid(mesh, lambda li, ti: pad(vs[(li, ti)])), ("led", "tile"),
                             wire))
    m = [mesh.local(mesh.psum(as_grid(mesh, lambda li, ti: mets[(li, ti)][i]), ("led", "tile")))
         for i in (0, 1)]
    want_pc = parent_pupil_step(pc, v, omax)
    want_acc = acc + torch.stack(m)

    blocks = [(objs[ti], [pay[(li, ti)] for li in range(led)],
               [[pay[(li, (ti - j) % tile)] for li in range(led)] for j, _, _ in hops])
              for ti in range(tile)]
    got = kernels.consensus_tile_object(blocks, s=s, hops=hops, wire=wire)
    for ti, (o, mx) in enumerate(got):
        assert equal(o, want_o[ti]) and equal(mx, local[0][ti])
    every = [(li, ti) for li in range(led) for ti in range(tile)]
    got_pc, got_max, got_acc = kernels.consensus_tile_pupil(
        pc, [vs[k] for k in every], [mx for _, mx in got], [mets[k][0] for k in every],
        [mets[k][1] for k in every], acc, wire=wire, scale=SCALE)
    assert equal(got_pc, want_pc) and equal(got_max, omax) and equal(got_acc, want_acc)


def test_tile_object_plain_on_the_complex_route_with_the_bf16_wire():
    """complex128 state from f32 planes payloads (the kernel route at
    complex128): the psum in f32 on the bf16 wire, then complex; the reverse
    halo's slab sent as bf16 (re, im) planes and received as complex128."""
    s, tile = 12, 4
    hops = hops_of(s)
    r = rng(3)
    o = cplx(r, s, NL, dtype=torch.complex128, scale=10)
    own = [planes(r, s + NP, NL, scale=0.1) for _ in range(2)]
    halos = [[planes(r, s + NP, NL, scale=0.1) for _ in range(2)] for _ in hops]
    wire = torch.bfloat16

    def psum(xs):
        acc = None
        for x in xs:
            x = x.to(wire).to(torch.float32)
            acc = x if acc is None else torch.add(acc, x)
        return torch.complex(acc[0], acc[1]).to(o.dtype)

    d_local = psum(own)[:s]
    for (_, lo, rows), src in zip(hops, halos):
        slab = psum(src)[s + lo:s + lo + rows]
        sent = torch.stack([slab.real, slab.imag]).to(wire)
        b = torch.complex(sent[0].float(), sent[1].float()).to(o.dtype)
        d_local = torch.cat([d_local[:rows] + b, d_local[rows:]], dim=-2)
    want = o + d_local
    got, mx = kernels.consensus_tile_object_plain(o, own, halos, s=s, hops=hops, wire=wire)
    assert equal(got, want) and equal(mx, torch.max(torch.abs(want)))
    assert tile == NL // s


def test_collect_gathers_each_groups_payloads_in_rank_order_and_counts_as_the_model():
    """``Mesh.collect`` hands each card its groups' payloads as they are
    (nothing moves on one device) and counts like ``Mesh.psum``; ``carried``
    counts a collective whose payloads another one carried."""
    mesh = cpu_mesh(2, 3)
    g = mesh.grid(lambda li, ti: torch.full((2, 4), 10.0 * li + ti))
    got = mesh.collect(g, "led", torch.bfloat16, chunk=0, what="x").result()
    (card, ranks), = mesh.cards()
    assert ranks == [(li, ti) for li in range(2) for ti in range(3)]
    assert set(got) == {card} and all(got[card][r] is g[r[0]][r[1]] for r in ranks)
    assert mesh.counts[("psum", "led")] == {"calls": 1, "payload_bytes": 16}
    like = torch.empty((2, 8, 8), device="meta")
    got = mesh.collect(g, ("led", "tile"), op="pmax", count_like=like, needs={card: [(1, 2)]},
                       chunk=0).result()
    assert list(got[card]) == [(1, 2)]
    assert mesh.counts[("pmax", "led,tile")] == {"calls": 1, "payload_bytes": 512}
    step = mesh.carried("ppermute", "tile", like, chunk=0, after=[0], what="reverse halo")
    assert mesh.schedule[step].op == "ppermute reverse halo"
    assert mesh.schedule[step].waits_on == (0,)
    assert mesh.counts[("ppermute", "tile")] == {"calls": 1, "payload_bytes": 512}


def test_consensus_wrappers_refuse_a_device_without_a_kernel():
    o = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.consensus_led(o, o, [o], [o])
    with pytest.raises(ValueError, match="no kernel"):
        kernels.consensus_tile_object([(o, [o], [])], s=4)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.consensus_tile_pupil(o, [o], [o])


# The launch of C1 and C2 (``kernels.consensus_plan``) at the main path's
# shapes and at its edges: (elements, NL, pupil elements, planes aligned) →
# (object blocks, pupil blocks, vector path). Blocks of 256 threads, 4
# elements of a plane a thread: 1024 elements a block.
CONSENSUS_PLANS = {
    "mono 4 1": ((360 * 360, 360, 64 * 64, True), (127, 4, True)),
    "mono 2 2": ((180 * 360, 360, 0, True), (64, 0, True)),
    "mono 1 8": ((45 * 360, 360, 0, True), (16, 0, True)),
    "dogStomach 4 1": ((600 * 600, 600, 112 * 112, True), (352, 13, True)),
    "dogStomach 2 2": ((300 * 600, 600, 0, True), (176, 0, True)),
    "NL not a multiple of 4": ((62 * 62, 62, 40 * 40, True), (4, 2, False)),
    "a plane off its 16 bytes": ((64 * 64, 64, 40 * 40, False), (4, 2, False)),
    "one element": ((1, 1, 1, True), (1, 1, False)),
    "one block exactly": ((1024, 64, 1024, True), (1, 1, True)),
    "one past a block": ((1025, 1025, 1025, True), (2, 2, False)),
}


@pytest.mark.parametrize("case", list(CONSENSUS_PLANS))
def test_consensus_plan_covers_every_element_once_on_the_path_the_planes_allow(case):
    (elements, nl, pupil, aligned), (blocks, pupil_blocks, vector) = CONSENSUS_PLANS[case]
    plan = kernels.consensus_plan(elements, aligned=aligned, nl=nl, pupil=pupil)
    assert (plan.blocks, plan.pupil_blocks, plan.vector) == (blocks, pupil_blocks, vector)
    assert (plan.threads, plan.per_thread) == (256, 4)
    per_block = plan.threads * plan.per_thread
    assert plan.blocks * per_block >= elements > (plan.blocks - 1) * per_block
    assert plan.pupil_blocks * per_block >= pupil > (plan.pupil_blocks - 1) * per_block


# The optics of the configurations the port runs at its main path's C3
# shapes: mono, the reference's dataset_mono.json (Np 90, pixel 6.5 µm,
# objective 8x NA 0.2, λ 0.5 µm: FPMConfig's defaults) with the dome's LEDs
# to NA 0.45; dogStomach, its dataset_dogStomach.json (Np 200, λ 0.63 µm,
# LEDs to NA 0.30).
REFERENCE_OPTICS = {"mono": dict(max_illumination_na=0.45),
                    "dogStomach": dict(np_size=200, max_illumination_na=0.30, wavelength=0.63)}


def reference_bbox(name: str) -> int:
    """The bbox b the kernels take at a REFERENCE_OPTICS configuration."""
    from fpm_torch.config import FPMConfig
    from fpm_torch.models import epry

    cfg = FPMConfig(**REFERENCE_OPTICS[name])
    return kernels.bbox_extent(cfg.np_size, epry.EPRYOptions.from_config(cfg).pupil_radius)[0]


def pupil_entry_accepts(bb: int, plan) -> bool:
    """csrc/epry_consensus.cu's ``pupil_plan_ok``, the C entry's check of
    C3's plan: blocks of 256 threads, an element a thread (kPupilPerThread),
    that cover the b² elements with no block left without one."""
    per_block = plan.threads * plan.per_thread
    return (plan.per_thread == 1 and plan.threads == 256 and plan.pupil_blocks >= 1
            and plan.pupil_blocks * per_block >= bb > (plan.pupil_blocks - 1) * per_block)


# C3's bbox b at the configurations the port runs, and at edges: one
# element, a pupil under a block (b 8: the CPU tests'), and b² a multiple
# of a block (b 32).
PUPIL_BBOXES = {"mono": None, "dogStomach": None, "one element": 1, "b 8": 8, "b 32": 32}


@pytest.mark.parametrize("case", list(PUPIL_BBOXES))
def test_pupil_plan_takes_each_pupil_element_once_where_the_c_entry_accepts_it(case):
    """``kernels.pupil_plan``: block p's thread t takes element p·256 + t:
    every one of the b² once, every block at least one; the C entry accepts
    that grid."""
    b = PUPIL_BBOXES[case] or reference_bbox(case)
    bb = b * b
    plan = kernels.pupil_plan(bb)
    assert (plan.blocks, plan.threads, plan.per_thread, plan.vector) == (0, 256, 1, False)
    taken = [[e for t in range(plan.threads) if (e := p * plan.threads + t) < bb]
             for p in range(plan.pupil_blocks)]
    assert sorted(e for es in taken for e in es) == list(range(bb))
    assert all(taken)
    assert pupil_entry_accepts(bb, plan)


@pytest.mark.parametrize("change", ["a block fewer", "a block more", "no block"])
@pytest.mark.parametrize("case", list(PUPIL_BBOXES))
def test_the_c_entry_refuses_a_pupil_grid_that_does_not_cover_b2_once(case, change):
    """The C entry's rule refuses C3's plan with a block fewer (an element
    left out), a block more (a block without one) or none."""
    b = PUPIL_BBOXES[case] or reference_bbox(case)
    plan = kernels.pupil_plan(b * b)
    blocks = {"a block fewer": plan.pupil_blocks - 1, "a block more": plan.pupil_blocks + 1,
              "no block": 0}[change]
    assert not pupil_entry_accepts(b * b, plan._replace(pupil_blocks=blocks))


def test_pupil_plan_at_the_main_path_bboxes():
    """The reference configurations' b (mono 64, dogStomach 112) and C3's
    grid at an element a thread (PUPIL_PER_THREAD): 16 and 49 blocks of
    256 threads."""
    assert (reference_bbox("mono"), reference_bbox("dogStomach")) == (64, 112)
    assert kernels.PUPIL_PER_THREAD == 1
    assert kernels.pupil_plan(64 * 64).pupil_blocks == 16
    assert kernels.pupil_plan(112 * 112).pupil_blocks == 49


@pytest.mark.parametrize("dtype,offset,aligned", [
    (torch.float32, 0, True), (torch.float32, 1, False), (torch.float32, 4, True),
    (torch.bfloat16, 0, True), (torch.bfloat16, 1, False), (torch.bfloat16, 2, False),
    (torch.bfloat16, 4, True)])
def test_consensus_planes_are_aligned_where_four_elements_load_as_one(dtype, offset, aligned):
    """``kernels._aligned``: a view ``offset`` elements into its buffer
    takes the vector path only where its four elements make 16 bytes (f32)
    or 8 (bf16) from an aligned start."""
    buf = torch.zeros(4 * 64 + 8, dtype=dtype)
    view = buf[offset:offset + 4 * 64].view(2, 2, 64)
    assert kernels._aligned([buf, view]) is aligned
    assert kernels._aligned([view, buf]) is aligned


def test_consensus_scratch_is_two_zero_words_a_tile():
    """Each launch's scratch: blocks arrived and the max's bits, for each
    of the CONSENSUS_MAX_TILES tiles, zero (the kernels leave it zero)."""
    scratch = kernels.ConsensusScratch("cpu")
    assert scratch.sync.dtype == torch.int32
    assert scratch.sync.shape == (kernels.CONSENSUS_SYNC_WORDS * kernels.CONSENSUS_MAX_TILES,)
    assert kernels.CONSENSUS_SYNC_WORDS == 2 and not scratch.sync.any()


# SHA-256 (first 16 hex digits) of the spectrum, pupil and metrics after 2
# sweeps at chunk 4 of synthetic_dataset(np_size=16, grid=5, seed=7) on CPU
# ranks, taken on the sweeps as they were before the consensus kernels (each
# rank's apply as eager ops after the mesh's psums).
PARENT_DIGESTS = {
    (4, 1, ()): "959d476468312f9e",
    (2, 1, (("comm_precision", "bf16"), ("stale_consensus", True))): "b9bb1d439a012789",
    (4, 1, (("use_pallas", False),)): "d85d6bda92ab117a",
    (2, 1, (("use_pallas", False), ("dtype", "complex128"))): "8d2ea9a32bf737b6",
    (2, 2, ()): "5c9e2586a5d69458",
    (2, 2, (("comm_precision", "bf16"), ("stale_consensus", True))): "61fa7cebad354b8d",
    (1, 4, (("comm_precision", "bf16"),)): "f0803896541b9e85",
    (1, 4, (("dtype", "complex128"), ("comm_precision", "bf16"),
            ("stale_consensus", True))): "6c53a7787b35515a",
    (2, 3, (("use_pallas", False), ("dtype", "complex128"),
            ("stale_consensus", True))): "5c2e252ec7fbffbb",
}


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(np_size=16, grid=5, seed=7)


@pytest.mark.parametrize("led,tile,options", list(PARENT_DIGESTS),
                         ids=[f"{led}x{tile}-" + "-".join(f"{v}" for _, v in o)
                              for led, tile, o in PARENT_DIGESTS])
def test_sharded_runs_are_bitwise_the_runs_before_the_consensus_kernels(ds, led, tile, options):
    kw = dict(dict(use_pallas=True), **dict(options))
    if not kw["use_pallas"]:
        del kw["use_pallas"]
    fn = tpar.reconstruct_led_sharded if tile == 1 else tpar.reconstruct_tile_sharded
    res = fn(ds.images, ds.geom, ds.cfg, mesh=cpu_mesh(led, tile), iterations=2, chunk_size=4,
             **kw)
    h = hashlib.sha256(res.obj_f_centered.tobytes())
    h.update(res.pupil.tobytes())
    for k in sorted(res.metrics):
        h.update(np.asarray(res.metrics[k]).tobytes())
    assert h.hexdigest()[:16] == PARENT_DIGESTS[(led, tile, options)]
