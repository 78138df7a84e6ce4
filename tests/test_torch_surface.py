"""The port's public solver surface against fpm_tpu's.

* Every name that ``fpm_tpu``'s package ``__init__`` files export, and
  every public top-level function and class of ``fpm_tpu/models/epry.py``,
  exists in the port's counterpart, apart from the deliberate differences
  named in DELIBERATE. The names are read with ``ast``, so that no JAX is
  imported for them.
* ``init_state`` in complex128 within 1e-10 of ``fpm_tpu``'s (the eager
  solver's limit, tests/test_torch_solver.py), the support bitwise.
* ``sweep_pallas`` (K2) and ``sweep_batched_pallas`` (K1) on CPU tensors,
  where the wrappers run their plain versions, against ``fpm_tpu``'s, which
  run its Pallas kernels in interpret mode, on the same seeded state: Np 64
  on a 5×5 grid (tests/test_pallas.py:49's size), the pupil's bbox from the
  config (48 at offset 8) and the whole patch (``pupil_radius`` 0, b = n),
  both tiers, at the limits of the K1 / K2 parity tests: rel-max 1e-5 on
  the spectrum, 1e-4 on the pupil, metrics rtol 1e-4 at ``highest``
  (tests/test_torch_kernels.py); 5e-5 / 5e-4 / 1e-3 at ``bf16x3``
  (tests/test_torch_bf16x3.py).

On the card the two functions are held bitwise to the kernel wrappers they
call (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpm_torch
from fpm_torch.models import epry as tepry
from fpm_tpu.data.simulate import synthetic_dataset
from fpm_tpu.geometry import pupil_support
from fpm_tpu.models import epry as jepry

REPO = Path(__file__).resolve().parents[1]
LIMITS = {"highest": (1e-5, 1e-4, 1e-4), "bf16x3": (5e-5, 5e-4, 1e-3)}

# fpm_tpu module → the port's counterpart, and the names the port leaves
# out on purpose (ROADMAP.md §3, deliberate differences): the MXU matmul-DFT
# path of ops/fft.py and the HLO inventory of parallel/comm.py.
MODULES = {"fpm_tpu/__init__.py": "fpm_torch",
           "fpm_tpu/models/__init__.py": "fpm_torch.models",
           "fpm_tpu/data/__init__.py": "fpm_torch.data",
           "fpm_tpu/ops/__init__.py": "fpm_torch.ops",
           "fpm_tpu/parallel/__init__.py": "fpm_torch.parallel"}
DELIBERATE = {"set_default_fft_impl", "dft_matrix", "hlo_collective_inventory"}


def exported(path: Path) -> set[str]:
    """The public names a package ``__init__`` imports from its modules."""
    return {a.asname or a.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) for a in node.names
            if not (a.asname or a.name).startswith("_")} - {"annotations"}


def public_defs(path: Path) -> set[str]:
    return {node.name for node in ast.parse(path.read_text()).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


@pytest.mark.parametrize("path,port", sorted(MODULES.items()))
def test_every_exported_name_of_fpm_tpu_is_the_ports(path, port):
    names = exported(REPO / path)
    assert names, path
    module = importlib.import_module(port)
    missing = sorted(n for n in names - DELIBERATE if not hasattr(module, n))
    assert not missing, f"{port} lacks {missing} of {path}"


def test_every_public_function_of_fpm_tpus_epry_is_the_ports():
    names = public_defs(REPO / "fpm_tpu" / "models" / "epry.py")
    for name in ("init_state", "sweep_pallas", "sweep_batched_pallas", "reconstruct"):
        assert name in names
    assert not sorted(n for n in names if not hasattr(tepry, n))


def test_the_deliberate_differences_are_fpm_tpus_and_absent_here():
    """Each name of DELIBERATE is exported by fpm_tpu and not by the port, so
    the list names no more than it must."""
    by_port = {port: exported(REPO / path) for path, port in MODULES.items()}
    for name in DELIBERATE:
        owners = [port for port, names in by_port.items() if name in names]
        assert owners, name
        assert not any(hasattr(importlib.import_module(port), name) for port in owners), name


def test_the_scan_reads_an_init_file(tmp_path):
    path = tmp_path / "__init__.py"
    path.write_text("from __future__ import annotations\nfrom .a import b, c as d, _e\n"
                    "import os\n\n\ndef f():\n    pass\n")
    assert exported(path) == {"b", "d"}
    assert public_defs(path) == {"f"}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def ds16():
    return synthetic_dataset(np_size=16, grid=5, seed=1)


def test_init_state_is_fpm_tpus_complex128(ds16):
    amps = np.sqrt(np.asarray(ds16.images, np.float64))[ds16.geom.schedule]
    ref = jepry.init_state(ds16.cfg, ds16.geom, amps, dtype=jnp.complex128)
    got = tepry.init_state(ds16.cfg, ds16.geom, amps, dtype=torch.complex128, device="cpu")
    assert [g.dtype for g in got] == [torch.complex128] * 3
    assert all(g.device.type == "cpu" for g in got)
    for r, g in zip(ref[:2], got[:2]):
        assert g.shape == r.shape
        assert rel(g.numpy(), np.asarray(r)) <= 1e-10
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[1].data_ptr() != got[2].data_ptr()      # the pupil is a tensor of its own
    o, p, s = tepry.init_state(ds16.cfg, ds16.geom, torch.from_numpy(amps),
                               dtype="complex64", device="cpu")
    assert (o.dtype, p.dtype, s.dtype) == (torch.complex64,) * 3


def test_init_state_is_reconstructs_init(ds16):
    """The state a kernel-route ``reconstruct`` starts from (0 sweeps)."""
    amps, _ = tepry._sorted_device_inputs(ds16.images, ds16.geom, torch.complex64, "cpu")
    o, p, _ = tepry.init_state(ds16.cfg, ds16.geom, amps, device="cpu")
    res = tepry.reconstruct(ds16.images, ds16.geom, ds16.cfg, iterations=0, device="cpu",
                            use_pallas=True)
    assert np.array_equal(o.numpy(), res.obj_f_centered)
    assert np.array_equal(p.numpy(), res.pupil)


@pytest.fixture(scope="module")
def np64():
    """A seeded state that is not the init (one sweep in, a pupil with
    phase) at Np 64, and both packages' operands."""
    ds = synthetic_dataset(np_size=64, grid=5, seed=5, aberrated_pupil=True)
    start = jepry.reconstruct(ds.images, ds.geom, ds.cfg, iterations=1, dtype="complex64")
    rng = np.random.default_rng(0)
    pupil = (start.pupil * np.exp(0.3j * rng.standard_normal(start.pupil.shape))).astype(
        np.complex64)
    obj = start.obj_f_centered.astype(np.complex64)
    amps, starts = (np.array(x) for x in jepry._sorted_device_inputs(
        ds.images, ds.geom, jnp.complex64))
    sup = pupil_support(ds.cfg, centered=False).astype(np.complex64)
    return ds, obj, pupil, amps, starts, sup


def options(ds, tier, radius, mode):
    kw = dict(dtype="complex64", use_pallas=True, dft_precision=tier, mode=mode,
              chunk_size=8 if mode == "batched" else 0)
    if radius == "whole patch":
        kw["pupil_radius"] = 0
    return (jepry.EPRYOptions.from_config(ds.cfg, **kw),
            tepry.EPRYOptions.from_config(ds.cfg, **kw))


@pytest.mark.parametrize("tier", ["highest", "bf16x3"])
@pytest.mark.parametrize("radius", ["config", "whole patch"])
@pytest.mark.parametrize("fn", ["sweep_pallas", "sweep_batched_pallas"])
def test_kernel_sweeps_match_fpm_tpus(np64, fn, radius, tier):
    ds, obj, pupil, amps, starts, sup = np64
    mode = "sequential" if fn == "sweep_pallas" else "batched"
    jopts, topts = options(ds, tier, radius, mode)
    assert topts.pupil_radius == jopts.pupil_radius
    assert (topts.pupil_radius == 0) == (radius == "whole patch")
    args = (amps, starts)
    if mode == "batched":
        k = amps.shape[0]
        perm, mask, n_chunks = tepry.chunk_schedule(k, 8, "strided")
        a = np.concatenate([amps, np.zeros((perm.size - k,) + amps.shape[1:], np.float32)])
        s = np.concatenate([starts, np.zeros((perm.size - k, 2), np.int32)])
        args = (a[perm].reshape(n_chunks, 8, *amps.shape[1:]), s[perm].reshape(n_chunks, 8, 2),
                mask.reshape(n_chunks, 8))
    ref = getattr(jepry, fn)(jnp.asarray(obj), jnp.asarray(pupil),
                             *(jnp.asarray(x) for x in args), support=jnp.asarray(sup),
                             opts=jopts)
    got = getattr(tepry, fn)(torch.from_numpy(obj), torch.from_numpy(pupil),
                             *(torch.from_numpy(x) for x in args), support=torch.from_numpy(sup),
                             opts=topts)
    (ro, rp, rm), (go, gp, gm) = (np.asarray(x) for x in ref), (x.numpy() for x in got)
    assert (go.dtype, gp.dtype, gm.dtype) == (ro.dtype, rp.dtype, rm.dtype)
    assert go.shape == ro.shape and gp.shape == rp.shape and gm.shape == (2,)
    tol_o, tol_p, tol_m = LIMITS[tier]
    assert rel(go, ro) < tol_o
    assert rel(gp, rp) < tol_p
    np.testing.assert_allclose(gm, rm, rtol=tol_m)


@pytest.mark.parametrize("fn", ["sweep_pallas", "sweep_batched_pallas"])
def test_kernel_sweeps_are_the_wrappers_and_keep_the_states_dtype(ds16, fn):
    """On the CPU each is its wrapper's plain version on the same planes,
    bit for bit, and a complex128 state comes back complex128 (the kernel
    route computes in float32, as fpm_tpu's does)."""
    from fpm_torch.ops import kernels

    mode = "sequential" if fn == "sweep_pallas" else "batched"
    opts = tepry.EPRYOptions.from_config(ds16.cfg, use_pallas=True, mode=mode, chunk_size=7,
                                         dft_precision="highest")
    amps, starts = tepry._sorted_device_inputs(ds16.images, ds16.geom, torch.complex64, "cpu")
    o, p, sup = tepry.init_state(ds16.cfg, ds16.geom, amps, device="cpu")
    kw = dict(np_size=ds16.cfg.np_size, n_large=ds16.cfg.n_large, delta1=ds16.cfg.delta1,
              delta2=ds16.cfg.delta2, eps=ds16.cfg.eps, pupil_radius=opts.pupil_radius,
              collect_metrics=opts.collect_metrics, dft_precision="highest")
    planes = (tepry._to_planes(o), tepry._to_planes(p), sup.real)
    if mode == "sequential":
        args, want = (amps, starts), kernels.fused_epry_sweep_plain(
            *planes, amps, starts.reshape(-1), global_max=opts.global_max, **kw)
    else:
        a, s, m = tepry.chunk_permute(amps, starts, 7, "strided", torch.float32)
        args, want = (a, s, m), kernels.fused_epry_chunked_plain(
            *planes, a, s.reshape(-1), (m > 0).reshape(-1).to(torch.int32),
            pupil_step_scale=opts.pupil_step_scale, **kw)
    got = getattr(tepry, fn)(o, p, *args, support=sup, opts=opts)
    assert torch.equal(got[0], torch.complex(want[0][0], want[0][1]))
    assert torch.equal(got[1], torch.complex(want[1][0], want[1][1]))
    assert torch.equal(got[2], want[2])
    wide = getattr(tepry, fn)(o.to(torch.complex128), p.to(torch.complex128),
                              *(x.to(torch.float64) if x.is_floating_point() else x
                                for x in args), support=sup.to(torch.complex128), opts=opts)
    assert (wide[0].dtype, wide[1].dtype, wide[2].dtype) == (
        torch.complex128, torch.complex128, torch.float64)
    assert torch.equal(wide[0], got[0].to(torch.complex128))


def test_the_package_surface_names_the_new_functions():
    assert fpm_torch.reconstruct_channels is tepry.reconstruct_channels
    assert callable(fpm_torch.default_dome_coordinates)
    import fpm_torch.models as models

    for name in ("init_state", "sweep_pallas", "sweep_batched_pallas", "led_step",
                 "sweep_batched", "sweep_sequential", "reconstruct_channels"):
        assert getattr(models, name) is getattr(tepry, name)
