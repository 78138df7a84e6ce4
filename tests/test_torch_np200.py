"""The dogStomach scale (Np=200) on the CPU: the port's kernel route (the
kernels' plain versions here) against fpm_tpu after one sweep, and the
chunk the kernel route runs against fpm_tpu's.

The problem is tests/test_tpu_hw.py:110-117's: Np 200, pixel 6.5 µm, mag 8,
NA 0.2, illumination NA 0.30, λ 0.63 µm on the built-in dome table (NL 600,
K 88, pupil radius 52, bbox 112 at offset 48), object ``make_test_object(600,
0)``, 16-bit frames. At ``highest`` the reference is fpm_tpu's XLA route
(FP32 products both); at ``bf16x3`` it is fpm_tpu's kernel route at
bf16x3, in interpret mode as its own tests run it on the CPU: against the
XLA route the two bf16x3 trajectories lie on either side (batched pupil:
the port 1.1e-5, fpm_tpu's kernel 5.9e-6). Tolerance: test_tpu_hw.py's,
rel-max 1e-5 on the object spectrum and on the pupil after one sweep (two
float32 trajectories that differ in summation order; measured ≤ 5e-7 /
6e-6).
"""

import itertools

import numpy as np
import pytest

from fpm_torch.config import FPMConfig as TorchConfig
from fpm_torch.models import epry as tepry
from fpm_torch.ops import kernels as tk
from fpm_tpu.config import FPMConfig as JaxConfig
from fpm_tpu.data.simulate import make_test_object, simulate_images
from fpm_tpu.geometry import compute_geometry
from fpm_tpu.models import epry as jepry

DOG = dict(np_size=200, pixel_size=6.5, objective_mag=8.0, objective_na=0.2,
           max_illumination_na=0.30, wavelength=0.63)
TOL = 1e-5
# K3's d at this shape: two float32 implementations lie up to 1.7e-4 of
# max|d| apart (test_k3_d_alone_is_out_of_reach_of_1e_5_at_this_shape).
D_WITNESS_NP200 = 3e-4


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def dog():
    cfg = JaxConfig(iterations=1, **DOG)
    geom = compute_geometry(cfg)
    images = simulate_images(make_test_object(cfg.n_large, seed=0), geom, cfg, quantize=True)
    return TorchConfig(iterations=1, **DOG), cfg, geom, images


@pytest.fixture(scope="module")
def reference(dog):
    """fpm_tpu's sweep at a tier: one sweep per (mode, tier), made once; a
    batched request of chunk 32 runs chunk 16 (its kernel route clamps it,
    and its XLA route is asked for 16)."""
    _, cfg, geom, images = dog
    made = {}

    def get(mode, tier):
        if (mode, tier) not in made:
            kw = (dict(chunk_size=16) if tier == "highest" else
                  dict(chunk_size=32, use_pallas=True, dft_precision=tier))
            made[mode, tier] = jepry.reconstruct(images, geom, cfg, iterations=1, mode=mode,
                                                 **kw)
        return made[mode, tier]
    return get


def test_the_shape_is_the_dogstomach_one(dog):
    tcfg, _, geom, _ = dog
    opts = tepry.EPRYOptions.from_config(tcfg, use_pallas=True)
    assert (tcfg.n_large, geom.num_leds, opts.pupil_radius) == (600, 88, 52)
    assert tk.bbox_extent(200, opts.pupil_radius) == (112, 48)


@pytest.mark.parametrize("tier", ["bf16x3", "highest"])
@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_plain_kernel_route_matches_fpm_tpu(dog, reference, mode, tier):
    """A batched request of chunk 32 runs chunk 16 in both packages."""
    tcfg, _, geom, images = dog
    got = tepry.reconstruct(images, geom, tcfg, iterations=1, device="cpu", mode=mode,
                            chunk_size=32, use_pallas=True, dft_precision=tier)
    ref = reference(mode, tier)
    assert rel(got.obj_f_centered, ref.obj_f_centered) < TOL
    assert rel(got.pupil, ref.pupil) < TOL


# (np, chunk, K, n_led): the shapes of the reference configs and around fpm_tpu's
# ceiling (34 at Np 90, 32 at 100, 16 at 200, 208 at 16).
GRID = list(itertools.product((16, 90, 100, 200), (0, 1, 7, 16, 17, 32, 34, 35, 64, 500),
                              (21, 88, 193, 293), (1, 2, 4, 8)))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_effective_chunk_size_is_fpm_tpus(mode, use_pallas):
    for np_size, chunk, k, n_led in GRID:
        assert tepry.effective_chunk_size(np_size, chunk, k, use_pallas, mode, n_led) == \
            jepry.effective_chunk_size(np_size, chunk, k, use_pallas, mode, n_led), \
            (np_size, chunk, k, n_led)
    assert tepry.effective_chunk_size(200, 32, 88, True, "batched") == 16
    assert tepry.effective_chunk_size(90, 0, 193, True, "batched") == 34


def test_k3_d_alone_is_out_of_reach_of_1e_5_at_this_shape(dog):
    """Fault F2 at Np 200: on K3's call as rank (0, 0) of mesh (2,2) makes
    it (tile 0's halo block of tile=2, its workset of chunk 0 at chunk 16,
    the state after one batched sweep), the port's plain d and fpm_tpu's
    interpret-mode d, two float32 implementations at ``highest``, lie about
    1.2e-4-1.5e-4 apart relative to max|d| (the CPU's thread count moves it):
    d is a sum of increments much smaller than their terms, so no
    implementation reaches 1e-5 here. d is held within D_WITNESS_NP200
    (under twice the largest distance two float32 versions of this d were
    measured apart: 1.7e-4, the plain version on an H100 against on the
    CPU, chip_smoke.py's dogstomach lines), v within 1e-4, and what the
    sharded sweep makes of them, O + d and P + v / max|O + d|, within 1e-5 /
    1e-4 (the limits the card holds K3 to at this shape)."""
    import jax.numpy as jnp
    import torch

    from fpm_torch.geometry import pupil_support
    from fpm_torch.parallel import tile_shard
    from fpm_tpu.ops import pallas_kernels as jk

    tcfg, _, geom, images = dog
    n, nl = 200, 600
    opts = tepry.EPRYOptions.from_config(tcfg, use_pallas=True)
    amps, starts = tepry._sorted_device_inputs(images, geom, torch.complex64, "cpu")
    sup = torch.as_tensor(pupil_support(tcfg), dtype=torch.float32)
    o0, p0 = tepry.init_traced(amps, sup, opts)
    o, p = (torch.stack([z.real, z.imag]).contiguous() for z in (o0, p0))
    a16, s16, m16 = tepry.chunk_permute(amps, starts, 16, "strided", torch.float32)
    common = dict(np_size=n, delta1=tcfg.delta1, delta2=tcfg.delta2, eps=tcfg.eps,
                  pupil_radius=opts.pupil_radius, collect_metrics=True,
                  dft_precision="highest")
    o1, p1, _ = tk.fused_epry_chunked(o, p, sup, a16, s16.reshape(-1),
                                      (m16 > 0).reshape(-1).to(torch.int32), n_large=nl,
                                      pupil_step_scale=1.0, **common)
    idx, s = tile_shard.partition_leds_by_tile(geom, nl, 2, 2, n, chunk_size=16)
    sel = torch.as_tensor(idx[0, 0, 0])
    live = sel >= 0
    args = (torch.cat([o1, o1[:, :n]], dim=1)[:, :s + n].contiguous(), p1, sup,
            amps[sel.clamp(min=0)] * live[:, None, None],
            (starts[sel.clamp(min=0)] * live[:, None]).to(torch.int32).reshape(-1),
            live.to(torch.int32))
    kw = dict(common, n_rows=s + n, n_cols=nl)
    ours = [t.numpy() for t in tk.fused_chunk_increments(*args, **kw)]
    theirs = [np.asarray(t) for t in jk.fused_chunk_increments(
        *(jnp.asarray(t.numpy()) for t in args), interpret=True, **kw)]
    assert rel(ours[0], theirs[0]) < D_WITNESS_NP200
    assert rel(ours[1], theirs[1]) < 1e-4

    def applied(d, v):
        o_new = args[0].numpy() + d
        return o_new, args[1].numpy() + v / np.sqrt((o_new[0] ** 2 + o_new[1] ** 2).max())

    (oa, pa), (ob, pb) = applied(*ours[:2]), applied(*theirs[:2])
    assert rel(oa, ob) < TOL and rel(pa, pb) < 1e-4
