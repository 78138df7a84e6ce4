"""The CUDA kernels K1 and K2 against their plain PyTorch versions, on the
card. They skip without a CUDA device. This file imports neither JAX nor
fpm_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Tolerances: rel-max 1e-5 on the object spectrum, 1e-4 on the pupil,
metrics rtol 1e-4 — float32 against float32, differing only in summation
order.
"""

import numpy as np
import pytest
import torch

from fpm_torch.data.simulate import synthetic_dataset
from fpm_torch.geometry import pupil_support
from fpm_torch.models import epry
from fpm_torch.ops import kernels

TOL_O, TOL_P, TOL_M = 1e-5, 1e-4, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is compared with its plain version there")
    return torch.device("cuda")


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def operands(ds, dev, mode, chunk=0):
    """Init-state planes and the sweep operands of one wrapper call."""
    opts = epry.EPRYOptions.from_config(ds.cfg, use_pallas=True, mode=mode, chunk_size=chunk)
    amps, starts = epry._sorted_device_inputs(ds.images, ds.geom, torch.complex64, dev)
    sup = torch.as_tensor(pupil_support(ds.cfg), dtype=torch.float32, device=dev)
    o, p = epry.init_traced(amps, sup, opts)
    planes = (torch.stack([o.real, o.imag]).contiguous(),
              torch.stack([p.real, p.imag]).contiguous(), sup)
    common = dict(np_size=ds.cfg.np_size, n_large=ds.cfg.n_large, delta1=ds.cfg.delta1,
                  delta2=ds.cfg.delta2, eps=ds.cfg.eps, pupil_radius=opts.pupil_radius,
                  collect_metrics=True)
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
def test_k2_matches_plain(cuda, np_size, global_max):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "sequential")
    before = kernels.fused_epry_sweep.launches
    kp = assert_kernel_matches_plain(kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                                     planes, rest, common, global_max=global_max)
    assert kernels.fused_epry_sweep.launches == before + 2 * (1 + ds.geom.num_leds)
    outside = torch.as_tensor(pupil_support(ds.cfg), device=cuda) == 0
    assert kp[:, outside].abs().max().item() == 0.0


@pytest.mark.parametrize("np_size,chunk", [(16, 7), (16, 0), (64, 6), (100, 8)])
def test_k1_matches_plain(cuda, np_size, chunk):
    ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
    planes, rest, common = operands(ds, cuda, "batched", chunk)
    before = kernels.fused_epry_chunked.launches
    assert_kernel_matches_plain(kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain,
                                planes, rest, common)
    n_chunks = rest[0].shape[0]
    assert kernels.fused_epry_chunked.launches == before + 2 * 3 * n_chunks


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


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_kernels_refuse_an_np_whose_buffers_do_not_fit_a_block(cuda, kernel):
    """One LED's buffers live in one block's shared memory: Np 90 (mono) and
    100 (cellScope) fit, as the cases above show; Np 200 (dogStomach) is
    refused before any launch."""
    n, nl = 200, 400
    o = torch.zeros((2, nl, nl), device=cuda)
    p, sup = torch.ones((2, n, n), device=cuda), torch.ones((n, n), device=cuda)
    amps = torch.ones((1, 1, n, n), device=cuda)
    starts = torch.zeros(2, dtype=torch.int32, device=cuda)
    common = dict(np_size=n, n_large=nl, delta1=5.0, delta2=10.0, eps=1e-10)
    before = (kernels.fused_epry_chunked.launches, kernels.fused_epry_sweep.launches)
    with pytest.raises(RuntimeError, match="shared memory"):
        if kernel == "K1":
            kernels.fused_epry_chunked(o, p, sup, amps, starts,
                                       torch.ones(1, dtype=torch.int32, device=cuda), **common)
        else:
            kernels.fused_epry_sweep(o, p, sup, amps[0], starts, **common)
    assert (kernels.fused_epry_chunked.launches, kernels.fused_epry_sweep.launches) == before
