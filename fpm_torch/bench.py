"""Benchmark of the port: LED-frames/s per GPU per sweep (``bench.py``'s metric).

Run from the repository root:

    python -m fpm_torch.bench                   # the headline, on the card
    python -m fpm_torch.bench --ablate          # K2's ablation rows
    python -m fpm_torch.bench --ablate --chunked    # K1's
    python -m fpm_torch.bench --device cpu      # a rehearsal on the CPU

Workload: ``bench.py``'s ``make_problem`` from the port's own config,
geometry and simulation: ``FPMConfig(max_illumination_na=0.45)`` (Np 90, NL
360, the 193 dome LEDs of the mono optics), ``make_test_object(360, seed)``,
16-bit frames. One sweep visits every LED once.

Headline: the chunked sweep (K1, ``fused_epry_chunked``), batched, chunk 32
strided, at ``bf16x3``: the sweep loop as ``reconstruct`` runs it
(``models.epry._make_problems_sweep_fn``), inputs on the card once. Its time
per sweep is the differential ladder of ``bench.py:90-149``: the minimum of
``reps`` runs of ``lo`` and of ``hi`` sweeps, each run timed with CUDA events
and ended by ``synchronize()``, (t_hi − t_lo) / (hi − lo), with the guard
against a degenerate differential (t_hi ≤ t_lo: measured again twice, then
t_hi / hi, an upper bound, flagged). Beside it one ``torch.profiler`` window
of a few sweeps gives the card's kernel ms per sweep, and ``busy_share`` is
that over the ladder's ms per sweep (the host enqueues K1's 21 launches a
sweep, so the card may wait on it; the profiler's own cost stays out of the
share).

``vs_baseline``: the float64 NumPy oracle (``fpm_torch.oracle``), one sweep on
this machine's CPU, cached in ``build/bench_baseline.json`` per problem,
host and CPU. ``bound_ms``/``bound_by``/``bound_share``: the least time the card could
take for one sweep's work, whatever implements it (:func:`sweep_work`: per
real LED the two 2-D transforms as pruned FFTs plus the element-wise work,
every input read and every output written once, against the H100 SXM's 67
TFLOP/s FP32 and 3.35 TB/s), and its share of the measured time. Specific to
this implementation: ``executed_tflops``, what the kernels' dense DFT
products (``cgemm_tc``, three bf16 ``mma`` passes) contract per second,
against 989 TFLOP/s bf16, and ``fft_stage_efficiency``, the ideal time of
those products over the time the DFT stage takes in this run (K1's time
less that of its ``no-dft`` ablation). Gate: the amplitude RMSE after 10
sweeps of ``reconstruct`` below 0.05, else exit 1.

stdout: exactly one JSON line (``--ablate``: one per row). The secondary
results (K2 sequential; K1 and K2 at P = 66 and 132 problems per launch; the
dogStomach shape, Np 200: K1 at chunk 16 and K2) go to stderr and
``build/bench_secondary.json``. Without a CUDA device it exits 1;
``--device cpu`` runs a tiny problem (Np 16, 5×5 LEDs) through the plain
versions and prints one ``"rehearsal": true`` line of host times (``cpu_*``)
and no device metric. The work accounting (``sweep_work``,
``increments_work``, ``bound``) is the one ``chip_smoke.py`` uses.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import FPMConfig
from .data.simulate import make_test_object, simulate_images, synthetic_dataset
from .geometry import compute_geometry
from .models import epry
from .ops import kernels

REPO = Path(__file__).resolve().parents[1]
BASELINE_CACHE = REPO / "build" / "bench_baseline.json"
SECONDARY_OUT = REPO / "build" / "bench_secondary.json"

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
RMSE_LIMIT = 0.05
RMSE_SWEEPS = 10
CHUNK = 32
LADDER = (10, 210, 8)        # lo, hi sweeps, repetitions: bench.py's
SECONDARY_LADDER = (5, 30, 3)
ABLATE_LADDER = (10, 110, 8)  # benchmarks/ablate.py's
DOG_OPTICS = dict(np_size=200, pixel_size=6.5, objective_mag=8.0, objective_na=0.2,
                  max_illumination_na=0.30, wavelength=0.63)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------ the problem


def make_problem(seed: int = 0, **optics):
    """(cfg, geom, images, object): ``bench.py``'s mono problem (or, with
    ``optics``, another), its object from ``seed``, 16-bit frames."""
    cfg = FPMConfig(**({"max_illumination_na": 0.45} | optics), iterations=1)
    geom = compute_geometry(cfg)
    obj_true = make_test_object(cfg.n_large, seed=seed)
    return cfg, geom, simulate_images(obj_true, geom, cfg, quantize=True), obj_true


def amplitude_rmse(obj, truth) -> float:
    """Scale-aligned amplitude RMSE, normalized by the mean true amplitude."""
    a, t = np.abs(obj), np.abs(truth)
    s = (t * a).sum() / (a * a).sum()
    return float(np.sqrt(((a * s - t) ** 2).mean()) / t.mean())


# ------------------------------------------------------- work and bound


def fft_flops(n: int) -> float:
    """Real FLOPs of one complex length-n FFT, the usual 5·n·log2(n)."""
    return 5 * n * math.log2(n)


# Element-wise FLOPs of one LED, as the kernels do them (epry_common.cuh):
# per image-plane element, amplitude replace (eps on both channels) 9 and
# data residual 7; per bbox element, Oc∘P 6, diff 2, object weight 11 and
# dO 6, pupil weight 10 and numerator 6, O update 2, pupil step 4, |O|² of
# the touched element for the max 3, update norm 4.
FLOPS_PER_IMAGE_ELEM = 16
FLOPS_PER_BBOX_ELEM = 54
# K3 returns the increments and applies nothing: no O update (2), pupil step
# (4) or |O|² for the max (3).
FLOPS_PER_BBOX_ELEM_K3 = FLOPS_PER_BBOX_ELEM - 9


def sweep_work(n_leds: int, n: int, b: int, nl: int, n_slots: int,
               has_valid: bool) -> tuple[int, float]:
    """(bytes, flops) one sweep needs at least: every input read once and
    every output written once; per real LED the two 2-D transforms as pruned
    FFTs (the b×b box zero-padded to n×n in, b×b kept out: 2·(n+b)
    length-n FFTs) plus the element-wise work."""
    flops = n_leds * (2 * (n + b) * fft_flops(n) + FLOPS_PER_IMAGE_ELEM * n * n
                      + FLOPS_PER_BBOX_ELEM * b * b)
    nbytes = (2 * 2 * nl * nl * 4            # O planes in and out
              + 2 * 2 * n * n * 4 + n * n * 4  # pupil in and out, support
              + n_leds * n * n * 4           # amplitude frames of real LEDs
              + n_slots * (3 if has_valid else 2) * 4  # starts (and valid)
              + 2 * 4)                       # metrics
    return nbytes, flops


def window_union(starts, valid, n: int, b: int, lo: int, n_rows: int, n_cols: int) -> int:
    """Elements of an (n_rows, n_cols) block that lie in the b×b window of at
    least one valid LED (patch starts clamped into the block, as the kernels
    clamp them): all of the block that a K3 call has to read."""
    covered = np.zeros((n_rows, n_cols), dtype=bool)
    for (y, x), ok in zip(starts, valid):
        if ok:
            y = min(max(int(y), 0), n_rows - n) + lo
            x = min(max(int(x), 0), n_cols - n) + lo
            covered[y:y + b, x:x + b] = True
    return int(covered.sum())


def increments_work(n_valid: int, n_slots: int, n: int, b: int, n_rows: int,
                    n_cols: int, o_elems: int) -> tuple[int, float]:
    """(bytes, flops) one K3 call needs at least: of the spectrum block only
    the ``o_elems`` elements inside a valid LED's window are read (once,
    where windows overlap); the increment block d is written once, whole, on
    every call; the pupil, support and numerator v, the valid LEDs' frames;
    per valid LED the transforms as pruned FFTs plus K3's element-wise work."""
    flops = n_valid * (2 * (n + b) * fft_flops(n) + FLOPS_PER_IMAGE_ELEM * n * n
                       + FLOPS_PER_BBOX_ELEM_K3 * b * b)
    nbytes = (2 * o_elems * 4                  # O: the valid windows' union, in
              + 2 * n_rows * n_cols * 4        # d: the whole block, out
              + 2 * 2 * n * n * 4 + n * n * 4  # pupil in, v out, support
              + n_valid * n * n * 4            # amplitude frames of valid LEDs
              + n_slots * 3 * 4 + 2 * 4)       # starts, valid, metrics
    return nbytes, flops


def bound(nbytes: int, flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def executed_mma_flops(n: int, b: int, cs: int) -> int:
    """FLOPs the tensor cores execute for one LED's four DFT products in
    this implementation (``cgemm_tc``, csrc/epry_common.cuh): each block of a
    cluster of ``cs`` forms its slabs' products in 16×8 output tiles over
    k-steps of 16, each k-step four real m16n8k16 products for each of the
    three passes; padded tiles count, as the card runs them."""
    def tiles(m, nn, k):
        return -(-m // 16) * -(-nn // 8) * -(-k // 16)

    total = 0
    for r0, r1 in kernels.slab_bounds(n, cs):
        rows = r1 - r0
        total += tiles(rows, b, b) + tiles(rows, n, b) + tiles(b, rows, n)   # T, img, V
    for r0, r1 in kernels.slab_bounds(b, cs):
        total += tiles(r1 - r0, b, n)                                        # up
    return total * 4 * 3 * 2 * 16 * 8 * 16


# ------------------------------------------------------------ the timing


def ladder(run, lo: int, hi: int, reps: int, log=_log) -> tuple[float, dict]:
    """Seconds per sweep from ``run(n)`` (the seconds n sweeps took): the
    minimum over ``reps`` runs at ``lo`` and at ``hi`` sweeps, (t_hi −
    t_lo) / (hi − lo). A degenerate differential (t_hi ≤ t_lo: a stall
    inflated the short runs) is measured again twice; if it stays
    degenerate, t_hi / hi, an upper bound that includes the fixed costs, is
    returned and flagged. Returns (seconds, {t_lo, t_hi, degenerate})."""
    def timed(n):
        return min(run(n) for _ in range(reps))

    run(lo), run(hi)                       # warm: every kernel built and loaded
    t_lo, t_hi = timed(lo), timed(hi)
    for _ in range(2):
        if t_hi > t_lo:
            break
        log(f"bench: degenerate differential (t_lo={t_lo:.6f} >= t_hi={t_hi:.6f}), "
            "re-measuring")
        t_lo, t_hi = timed(lo), timed(hi)
    info = {"t_lo": t_lo, "t_hi": t_hi, "lo": lo, "hi": hi, "reps": reps,
            "degenerate": t_hi <= t_lo}
    if not info["degenerate"]:
        return (t_hi - t_lo) / (hi - lo), info
    log("bench: differential still degenerate; reporting the upper bound t_hi/hi")
    return t_hi / hi, info


def cuda_clock(sweeps, state):
    """``run(n)`` for :func:`ladder`: n calls of ``sweeps(state) -> state``
    from ``state``, between two CUDA events, ended by ``synchronize()``."""
    def run(n):
        s = state
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            s = sweeps(s)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3
    return run


def host_clock(sweeps, state):
    """``run(n)`` for :func:`ladder` on the CPU: the host's clock."""
    def run(n):
        s = state
        t0 = time.perf_counter()
        for _ in range(n):
            s = sweeps(s)
        return time.perf_counter() - t0
    return run


def profiled(sweeps, state, n: int = 5) -> float:
    """Device ms per sweep of ``n`` sweeps under torch.profiler: the card's
    kernel time summed over the window."""
    from torch.profiler import ProfilerActivity, profile

    sweeps(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = state
        for _ in range(n):
            s = sweeps(s)
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "device_time_total", 0) or 0 for e in prof.key_averages())
    return device_us / 1e3 / n


# ----------------------------------------------------------- the solver


@dataclasses.dataclass
class Solve:
    """P copies of one problem on the kernel route as ``reconstruct_channels``
    sets them up: the kernel call of a sweep (``wrapper(o, p, *operands,
    **options)``, ``models.epry._problems_kernel_call``) and the init state."""
    opts: epry.EPRYOptions
    wrapper: object
    operands: tuple
    options: dict
    state: tuple
    n_slots: int

    def sweeps(self, ablate: str | None = None):
        """``sweep(state) -> state``: one sweep, as ``reconstruct`` makes it
        (``ablate``: a variant of the kernel, a measurement aid)."""
        extra = {} if ablate is None else {"ablate": ablate}

        def sweep(state):
            o, p, _ = self.wrapper(*state, *self.operands, **self.options, **extra)
            return o, p
        return sweep


def solver(cfg, geom, images, device, problems: int = 1, **overrides) -> Solve:
    """The kernel route's sweep of ``problems`` copies of the problem from
    its init, inputs on ``device`` once."""
    dev = torch.device(device)
    overrides = {"use_pallas": True, "collect_metrics": False, **overrides}
    _, opts, support_r = epry._solver_setup(geom, cfg, None, None, dev, overrides)
    amps, starts = epry._sorted_device_inputs(images, geom, opts.cdtype, dev)
    o0, p0 = epry.init_traced(amps, support_r, opts)
    state = tuple(torch.stack([epry._to_planes(z)] * problems).contiguous() for z in (o0, p0))
    wrapper, operands, options = epry._problems_kernel_call(
        amps.expand(problems, *amps.shape).contiguous(), starts, support_r, opts)
    k = len(geom.schedule)
    n_slots = (epry.chunk_schedule(k, opts.chunk_size, opts.chunk_assign)[0].size
               if opts.mode == "batched" else k)
    return Solve(opts, wrapper, operands, options, state, n_slots)


def rmse_after(cfg, geom, images, truth, device, **overrides) -> float:
    """Amplitude RMSE of ``reconstruct`` after RMSE_SWEEPS sweeps."""
    res = epry.reconstruct(images, geom, cfg, iterations=RMSE_SWEEPS, device=device,
                           **{"use_pallas": True, **overrides})
    return amplitude_rmse(res.obj_crop, truth)


def headline_mode(chunk: int = CHUNK) -> dict:
    return {"mode": "batched", "chunk_size": chunk, "chunk_assign": "strided",
            "dft_precision": "bf16x3"}


# ----------------------------------------------------------- the baseline


def _cpu_name() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def oracle_baseline(cfg, geom, images, cache: Path = BASELINE_CACHE) -> dict:
    """LED-frames/s of one sweep of the float64 NumPy oracle on this
    machine's CPU, cached in ``cache`` per problem, host and CPU model."""
    from .oracle import run_fpm_oracle

    key = (f"np{cfg.np_size}_nl{cfg.n_large}_k{int(geom.num_leds)}"
           f"_{platform.node()}_{_cpu_name()}")
    doc = json.loads(cache.read_text()) if cache.exists() else {}
    if key not in doc:
        t0 = time.perf_counter()
        run_fpm_oracle(images, geom, cfg, iterations=1)
        dt = time.perf_counter() - t0
        doc[key] = {"led_frames_per_s": int(geom.num_leds) / dt, "seconds_per_iter": dt,
                    "num_leds": int(geom.num_leds), "np": cfg.np_size, "cpu": _cpu_name(),
                    "cpu_count": os.cpu_count(),
                    "what": "float64 NumPy oracle (fpm_torch.oracle), one sweep, this CPU"}
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps(doc, indent=1))
    return doc[key]


def device_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------- the ablations


def ablation_rows(cfg, geom, images, device, chunked: bool, ladder_=ABLATE_LADDER,
                  variants=None) -> list[dict]:
    """``benchmarks/ablate.py``'s rows: ns per LED (K2) or per slot (K1, chunk
    32 strided) of each ablation variant, from the sweep-count ladder
    ``ladder_``, each variant from the same init state and at the cluster
    size the kernel itself takes. "(full)" is ``ablate=""`` through the
    ablation build, the variants' yardstick (``main_build_ns``: the main
    kernel's, the same ladder). K2 also times the bbox off, the lazy max|O|,
    ``highest`` and ``highest`` ``no-dft``. ``variants``: only the rows of
    those names ("" for the yardstick), in the same order."""
    lo, hi, reps = ladder_
    if chunked:
        wrapper, names = kernels.fused_epry_chunked, kernels.CHUNKED_ABLATIONS
        configs = [("bf16x3", a, True, "exact") for a in names]
        mode = {"mode": "batched", "chunk_size": CHUNK}
    else:
        wrapper, names = kernels.fused_epry_sweep, kernels.SWEEP_ABLATIONS
        configs = ([("bf16x3", a, True, "exact") for a in names]
                   + [("bf16x3", "", False, "exact"), ("bf16x3", "", True, "lazy"),
                      ("highest", "", True, "exact"), ("highest", "no-dft", True, "exact")])
        mode = {"mode": "sequential"}
    if variants is not None:
        configs = [c for c in configs if c[1] in variants]
    rows, base_ns = [], None
    for tier, ablate, bbox, gmax in configs:
        solve = solver(cfg, geom, images, device, dft_precision=tier, global_max=gmax,
                       **mode, **({} if bbox else {"pupil_radius": 0}))
        sweep = solve.sweeps(ablate)
        row = ({"kernel": "chunked", "chunk": CHUNK, "ablate": ablate or "(full)"} if chunked
               else {"kernel": "sequential", "dft_precision": tier, "ablate": ablate or "(full)",
                     "pupil_bbox": bbox, "global_max": gmax})
        try:
            if not ablate:
                main_s, _ = ladder(cuda_clock(sweep, solve.state), lo, hi, reps)
                row["main_build_ns"] = main_s * 1e9 / solve.n_slots
            wrapper.force_ablation_build = True
            sweep(solve.state)
            wrapper.force_cluster_size = row["cluster_size"] = wrapper.cluster_size
            sec, info = ladder(cuda_clock(sweep, solve.state), lo, hi, reps)
        finally:
            wrapper.force_cluster_size = 0
            wrapper.force_ablation_build = False
        ns = sec * 1e9 / solve.n_slots
        row["ns_per_slot" if chunked else "ns_per_led"] = ns
        row["degenerate"] = info["degenerate"]
        if ablate == "" and tier == "bf16x3" and bbox and gmax == "exact":
            base_ns = ns
        elif base_ns is not None:
            row["delta_vs_full_ns"] = ns - base_ns
        rows.append(row)
    return rows


# ------------------------------------------------------------ the runs


def headline(seed: int = 0) -> dict:
    """The headline line on the card (see the module docstring)."""
    device = "cuda"
    cfg, geom, images, truth = make_problem(seed)
    k, n, nl = int(geom.num_leds), cfg.np_size, cfg.n_large
    solve = solver(cfg, geom, images, device, **headline_mode())
    sweep = solve.sweeps()
    sec, info = ladder(cuda_clock(sweep, solve.state), *LADDER)
    device_ms = profiled(sweep, solve.state)
    cs = kernels.fused_epry_chunked.plan["cs"]
    b, _ = kernels.bbox_extent(n, solve.opts.pupil_radius)
    bound_ms, bound_by = bound(*sweep_work(k, n, b, nl, solve.n_slots, has_valid=True))
    executed = executed_mma_flops(n, b, cs) * k
    # The DFT stage of this run: K1 less its no-dft ablation, per real LED.
    rows = {r["ablate"]: r["ns_per_slot"] for r in ablation_rows(
        cfg, geom, images, device, chunked=True, variants=("", "no-dft"))}
    dft_ns = (rows["(full)"] - rows["no-dft"]) * solve.n_slots / k
    ideal_ns = executed_mma_flops(n, b, cs) / PEAK_BF16_FLOPS * 1e9
    base = oracle_baseline(cfg, geom, images)
    fps = k / sec
    return {
        "metric": "led_frames_per_s_per_gpu_per_iter", "value": fps, "unit": "LED-frames/s",
        "vs_baseline": fps / base["led_frames_per_s"],
        "baseline_led_frames_per_s": base["led_frames_per_s"],
        "seconds_per_iteration": sec, "device_ms_per_sweep": device_ms,
        "busy_share": device_ms / (sec * 1e3),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / (sec * 1e3),
        "executed_tflops": executed / sec / 1e12,
        "fft_stage_efficiency": ideal_ns / dft_ns if dft_ns > 0 else None,
        "implementation_specific": (
            "executed_tflops: the tensor-core FLOPs of this implementation's dense DFT "
            f"products (cgemm_tc, 3 bf16 passes, cluster size {cs}) per second, against "
            f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16; fft_stage_efficiency: their time at "
            "that peak over this run's DFT stage (K1 less its no-dft ablation)"),
        "amp_rmse_10": rmse_after(cfg, geom, images, truth, device, **headline_mode()),
        "num_leds": k, "np_size": n, "n_large": nl,
        "mode": "batched(chunk32-strided, fused_epry_chunked CUDA, bf16x3-dft)",
        "ladder": info, "baseline": base, "device": device_line()}


def secondary(seed: int = 0) -> dict:
    """K2 sequential; K1 and K2 at P = 66 and 132 copies of the problem per
    launch; the dogStomach shape (K1 at the chunk the kernel route runs, K2)."""
    out = {}

    def one(name, cfg, geom, images, problems=1, **over):
        solve = solver(cfg, geom, images, "cuda", problems, **over)
        sec, info = ladder(cuda_clock(solve.sweeps(), solve.state), *SECONDARY_LADDER)
        k = int(geom.num_leds)
        out[name] = {"seconds_per_iteration": sec, "ms_per_problem_sweep": sec * 1e3 / problems,
                     "led_frames_per_s": problems * k / sec, "problems": problems,
                     "chunk_size": solve.opts.chunk_size if solve.opts.mode == "batched" else None,
                     "cluster_size": solve.wrapper.cluster_size, "degenerate": info["degenerate"]}
        _log(f"bench[{name}]: {problems * k / sec:,.0f} LED-frames/s")

    mono = make_problem(seed)[:3]
    one("k2_sequential", *mono, mode="sequential")
    for p in (66, 132):
        one(f"k1_chunk32_p{p}", *mono, p, **headline_mode())
        one(f"k2_sequential_p{p}", *mono, p, mode="sequential")
    dog = make_problem(seed, **DOG_OPTICS)[:3]
    one("dogstomach_k1", *dog, **headline_mode())
    one("dogstomach_k2", *dog, mode="sequential")
    return out


def rehearsal(seed: int = 0) -> dict:
    """A tiny problem (Np 16, 5×5 LEDs) through the plain versions on the
    CPU: the same steps, host times under ``cpu_*``, no device metric."""
    ds = synthetic_dataset(np_size=16, grid=5, seed=seed)
    cfg, geom, images = ds.cfg, ds.geom, ds.images
    solve = solver(cfg, geom, images, "cpu", **headline_mode(chunk=8))
    sec, info = ladder(host_clock(solve.sweeps(), solve.state), 1, 4, 2)
    for ablate in kernels.CHUNKED_ABLATIONS:     # every variant runs
        solve.sweeps(ablate)(solve.state)
    base = oracle_baseline(cfg, geom, images)
    k = int(geom.num_leds)
    return {"rehearsal": True, "device": "cpu", "cpu_seconds_per_iteration": sec,
            "cpu_led_frames_per_s": k / sec,
            "cpu_baseline_led_frames_per_s": base["led_frames_per_s"],
            "amp_rmse_10": rmse_after(cfg, geom, images, ds.object_true, "cpu",
                                      **headline_mode(chunk=8)),
            "num_leds": k, "np_size": cfg.np_size, "n_large": cfg.n_large,
            "mode": "batched(chunk8-strided, plain versions, bf16x3-dft)", "ladder": info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the test object")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default); cpu: a rehearsal through the plain versions")
    ap.add_argument("--ablate", action="store_true",
                    help="time each ablation variant of K2 (benchmarks/ablate.py's rows)")
    ap.add_argument("--chunked", action="store_true", help="with --ablate: K1 at chunk 32")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        if args.ablate:
            ap.error("--ablate times the card's kernels: it has no CPU rehearsal")
        print(json.dumps(rehearsal(args.seed)), flush=True)
        return 0
    if not torch.cuda.is_available():
        _log("fpm_torch.bench: no CUDA device is available (--device cpu rehearses on the CPU)")
        return 1
    if args.ablate:
        cfg, geom, images, _ = make_problem(args.seed)
        for row in ablation_rows(cfg, geom, images, "cuda", args.chunked):
            print(json.dumps(row), flush=True)
        return 0
    line = headline(args.seed)
    print(json.dumps(line), flush=True)
    if not line["amp_rmse_10"] < RMSE_LIMIT:
        _log(f"fpm_torch.bench: amplitude RMSE after 10 sweeps {line['amp_rmse_10']} "
             f"is not below {RMSE_LIMIT}")
        return 1
    doc = {"headline": line, **secondary(args.seed)}
    SECONDARY_OUT.parent.mkdir(parents=True, exist_ok=True)
    SECONDARY_OUT.write_text(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
