"""``ablate=`` of K1 and K2 (a measurement aid that turns one kernel stage
off): the port's plain ``fused_epry_sweep`` / ``fused_epry_chunked`` with
each variant against fpm_tpu's Pallas kernel with the same ``ablate``, run
in interpret mode as its own tests run it on the CPU, on identical planes
from a state that is not the init (one sweep in, a pupil with phase).

Sizes are tests/test_pallas.py's: Np 16 on a 5×5 grid (the bbox is the
whole patch) and Np 64 (bbox 48 at offset 8, so ``no-window-read``'s corner
and ``no-dft``'s zero padding lie inside a patch larger than the box).
Limits, rel-max on the object spectrum / the pupil and rtol on the metrics:
at ``highest`` 1e-5 / 1e-4 / 1e-4 (FP32 against FP32, summation order
only); at ``bf16x3`` the tier's 5e-5 / 5e-4 / 1e-3 (tests/test_pallas.py);
``no-dft`` has no product and is held to 1e-5 / 1e-4 / 1e-4 at both tiers;
``dft-1pass`` forms each product as one pass of exact bf16 products, hi·hi,
at either tier, so it is held to the bf16x3 tier's limits at both.

Each variant also has to change the kernel's result (it turns a stage
off), the names outside a kernel's list raise, and the solver never passes
``ablate``. The CUDA kernels are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py's ``bench`` phase).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpm_torch.models import epry as tepry
from fpm_torch.ops import kernels as tk
from fpm_tpu.data.simulate import synthetic_dataset
from fpm_tpu.geometry import pupil_support
from fpm_tpu.models.epry import EPRYOptions, _sorted_device_inputs
from fpm_tpu.models.epry import reconstruct as jreconstruct
from fpm_tpu.ops import pallas_kernels as jk

REPO = Path(__file__).resolve().parents[1]
CHUNK = 8
LIMITS = {"highest": (1e-5, 1e-4, 1e-4), "bf16x3": (5e-5, 5e-4, 1e-3)}


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def limits(tier, ablate):
    if ablate == "no-dft":
        return LIMITS["highest"]
    return LIMITS["bf16x3" if ablate == "dft-1pass" else tier]


@pytest.fixture(scope="module", params=[16, 64], ids=["np16", "np64-bbox"])
def problem(request):
    """Planes, support and both kernels' operands of one size."""
    n = request.param
    ds = synthetic_dataset(np_size=n, grid=5, seed=5, aberrated_pupil=True)
    cfg = ds.cfg
    start = jreconstruct(ds.images, ds.geom, cfg, iterations=1, dtype="complex64")
    rng = np.random.default_rng(0)
    pupil = start.pupil * np.exp(0.3j * rng.standard_normal(start.pupil.shape))
    planes = [np.stack([z.real, z.imag]).astype(np.float32)
              for z in (start.obj_f_centered, pupil)]
    sup = pupil_support(cfg).astype(np.float32)
    opts = EPRYOptions.from_config(cfg, dtype="complex64", use_pallas=True)
    # The spectrum's corner is 0 after a sweep (no window reaches it), which
    # would make no-window-read's windows all zeros: values there.
    b, _ = tk.bbox_extent(n, opts.pupil_radius)
    corner = planes[0][:, :b, :b]
    corner += (0.01 * np.abs(planes[0]).max()
               * rng.standard_normal(corner.shape)).astype(np.float32)
    amps, starts = (np.asarray(x) for x in _sorted_device_inputs(ds.images, ds.geom,
                                                                 jnp.complex64))
    k = amps.shape[0]
    perm, mask, n_chunks = tepry.chunk_schedule(k, CHUNK, "strided")
    a = np.concatenate([amps, np.zeros((perm.size - k, n, n), np.float32)])
    s = np.concatenate([starts, np.zeros((perm.size - k, 2), np.int32)])
    rest = {"K2": ((amps, starts.reshape(-1)), {}),
            "K1": ((a[perm].reshape(n_chunks, CHUNK, n, n), s[perm].reshape(-1),
                    (mask > 0).astype(np.int32)), dict(pupil_step_scale=1.0))}
    common = dict(np_size=n, n_large=cfg.n_large, delta1=cfg.delta1, delta2=cfg.delta2,
                  eps=cfg.eps, pupil_radius=opts.pupil_radius, collect_metrics=True)
    return (*planes, sup), rest, common


def scaled(problem):
    """The problem with the spectrum and the frames divided by max|O|:
    omax-const's max|O| = 1 + k is then of the order of the true one. From
    the state as it is the pupil steps are ~1e4 times the true ones, and
    both packages' pupils reach 1e13 (Np 16) or overflow to NaN (Np 64)
    within the sweep, where two float32 summation orders part (K2 1.8e-3
    apart on O at Np 16)."""
    (o, p, sup), rest, common = problem
    s = np.float32(1.0 / np.sqrt((o[0] ** 2 + o[1] ** 2).max()))
    rest = {k: ((args[0] * s, *args[1:]), extra) for k, (args, extra) in rest.items()}
    return (o * s, p, sup), rest, common


KERNELS = {"K2": (jk.fused_epry_sweep, tk.fused_epry_sweep, tk.SWEEP_ABLATIONS),
           "K1": (jk.fused_epry_chunked, tk.fused_epry_chunked, tk.CHUNKED_ABLATIONS)}
CASES = [(kernel, ablate) for kernel, (_, _, names) in KERNELS.items() for ablate in names]


def run_both(problem, kernel, tier, ablate):
    planes, rest, common = problem
    args, extra = rest[kernel]
    jax_fn, torch_fn, _ = KERNELS[kernel]
    ref = jax_fn(*(jnp.asarray(x) for x in (*planes, *args)), interpret=True,
                 dft_precision=tier, ablate=ablate, **common, **extra)
    got = torch_fn(*(torch.tensor(np.asarray(x)) for x in (*planes, *args)),
                   dft_precision=tier, ablate=ablate, **common, **extra)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("tier", ["highest", "bf16x3"])
@pytest.mark.parametrize("kernel,ablate", CASES)
def test_plain_ablation_matches_fpm_tpus(problem, kernel, ablate, tier):
    if ablate == "omax-const":
        problem = scaled(problem)
    (ro, rp, rm), (go, gp, gm) = run_both(problem, kernel, tier, ablate)
    tol_o, tol_p, tol_m = limits(tier, ablate)
    assert go.shape == ro.shape and gp.shape == rp.shape
    assert rel(go, ro) < tol_o
    assert rel(gp, rp) < tol_p
    np.testing.assert_allclose(gm, rm, rtol=tol_m)
    if ablate:   # the variant turns a stage off: the result is not the kernel's
        _, (fo, fp, _) = run_both(problem, kernel, tier, "")
        assert not (np.allclose(go, fo, rtol=0, atol=1e-6 * np.abs(fo).max())
                    and np.allclose(gp, fp, rtol=0, atol=1e-6 * np.abs(fp).max()))


def test_np16_holds_every_variant_at_b_equal_n(problem):
    """The cases above hold each variant of both kernels at b = n (Np 16:
    the bbox is the whole patch, as at Np 200 with ``pupil_radius`` 0, where
    the card's kernels cut Z by rows) and at b < n (Np 64)."""
    _, _, common = problem
    n = common["np_size"]
    b, lo = tk.bbox_extent(n, common["pupil_radius"])
    assert (b, lo) == (n, 0) if n == 16 else b < n


@pytest.mark.parametrize("kernel,ablate", [("K2", "no-pupil-acc"), ("K2", "bogus"),
                                           ("K1", "bogus"), ("K1", "no_dft")])
def test_a_name_outside_the_kernels_list_raises(problem, kernel, ablate):
    planes, rest, common = problem
    args, extra = rest[kernel]
    plain = {"K2": tk.fused_epry_sweep_plain, "K1": tk.fused_epry_chunked_plain}[kernel]
    for fn in (KERNELS[kernel][1], plain):
        with pytest.raises(ValueError, match="no ablation"):
            fn(*(torch.tensor(np.asarray(x)) for x in (*planes, *args)), ablate=ablate,
               **common, **extra)


def test_the_lists_are_fpm_tpus():
    """The names and order of benchmarks/ablate.py's VARIANTS and
    CHUNKED_VARIANTS (read from its source: it imports JAX's package)."""
    tree = ast.parse((REPO / "benchmarks" / "ablate.py").read_text())
    lists = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets if isinstance(t, ast.Name)
             and t.id in ("VARIANTS", "CHUNKED_VARIANTS")}
    assert tuple(lists["VARIANTS"]) == tk.SWEEP_ABLATIONS
    assert tuple(lists["CHUNKED_VARIANTS"]) == tk.CHUNKED_ABLATIONS


def test_the_solver_never_passes_ablate():
    """No call in models/ or parallel/ names ``ablate``: the main path runs
    the kernels themselves."""
    files = sorted((REPO / "fpm_torch" / "models").glob("*.py")) + sorted(
        (REPO / "fpm_torch" / "parallel").glob("*.py"))
    assert len(files) > 5
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                assert all(kw.arg != "ablate" for kw in node.keywords), path
            assert not (isinstance(node, ast.Constant) and node.value in tk._ABLATE_IDS
                        and node.value), (path, node.value)
