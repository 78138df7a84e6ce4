#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fpm_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``; it never imports JAX or
``fpm_tpu``. On the mono dome problem (``FPMConfig(max_illumination_na=0.45)``:
Np=90, Nlarge=360, K=193 LEDs, NA-disk bbox 64 at offset 15; object made
from ``--seed``) it runs, each phase printing one JSON line:

1. ``device``: the card's name and power limit (``nvidia-smi``), the torch
   version, and the time to build the kernels from ``fpm_torch/ops/csrc``.
2. ``kernel_vs_plain``: K1 (chunk 32, strided) and K2 (exact and lazy max)
   against their plain PyTorch versions on the card, 2 sweeps from the same
   init state: rel-max |ΔO| ≤ 1e-5, rel-max |ΔP| ≤ 1e-4 (f32 against f32,
   differing only in summation order), metrics rtol 1e-4, and the kernels'
   pupil exactly 0 outside the NA support.
3. ``main_path``: the dataset written as TIFFs + ``dataset.json``, then
   ``python -m fpm_torch run ... -n 10 --use-pallas`` (through
   ``fpm_torch.cli.main``) in ``batched`` (chunk 32) and ``sequential``
   mode; each run's kernel launch counters start at 0 and must move; the
   output file set must be complete and the amplitude RMSE against the
   true object below 0.05.
4. ``timing``: per-sweep milliseconds of each kernel (through its wrapper),
   of its plain version on the card, and of the eager ``torch.fft`` sweep
   (``library_ms``); the launches of one sweep, counted by the wrapper; and
   the least time the card could take (``bound_ms``: the sweep's work done
   as pruned FFTs plus its element-wise work, and its bytes, against the
   H100 SXM peaks of 67 TFLOP/s FP32 and 3.35 TB/s).

Then the ``kernels`` line, the ``nvidia-smi`` line, and the result line.
Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing anything.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL_O, TOL_P, TOL_METRICS = 1e-5, 1e-4, 1e-4
RMSE_LIMIT = 0.05
OUTPUT_FILES = ("object.npy", "object_spectrum.npy", "pupil.npy", "object_amp.png",
                "object_phase.png", "pupil_amp.png", "pupil_phase.png",
                "manifest.json", "metrics.jsonl")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn) -> dict[str, float]:
    """Device milliseconds of one call, summed by kernel name, from
    torch.profiler's CUDA activity (empty if the profiler saw no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", 0) or 0
        if us > 0:
            name = evt.key.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def amplitude_rmse(obj, truth) -> float:
    """Scale-aligned amplitude RMSE, normalized by the mean true amplitude."""
    import numpy as np

    a, t = np.abs(obj), np.abs(truth)
    s = (t * a).sum() / (a * a).sum()
    return float(np.sqrt(((a * s - t) ** 2).mean()) / t.mean())


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


def bound(nbytes: int, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def write_dataset(out_dir, cfg, geom, frames) -> str:
    """The mono dome stack as ``iLED_<n>.tif`` frames plus ``dataset.json``
    (no background, whole frame = ROI; LED positions from the dome table)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, led in enumerate(geom.led_numbers):
        Image.fromarray(frames[i]).save(os.path.join(out_dir, f"iLED_{led}.tif"))
    doc = {
        "datasetRoot": os.path.abspath(out_dir) + os.sep, "filePrefix": "iLED_",
        "fileExtension": ".tif", "cropSizeX": cfg.np_size, "pixelSize": cfg.pixel_size,
        "objectiveMag": cfg.objective_mag, "objectiveNA": cfg.objective_na,
        "maxIlluminationNA": cfg.max_illumination_na, "lambda": cfg.wavelength,
        "cropX": 0, "cropY": 0, "bk1cropX": 0, "bk1cropY": 0, "bk2cropX": 0,
        "bk2cropY": 0, "bgThresh": 0, "delta1": cfg.delta1, "delta2": cfg.delta2,
        "ledCount": cfg.led_count,
    }
    path = os.path.join(out_dir, "dataset.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the test object")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    import numpy as np

    from fpm_torch import cli
    from fpm_torch.config import FPMConfig
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry, pupil_support
    from fpm_torch.models import epry
    from fpm_torch.ops import build, kernels

    # ------------------------------------------------------------ 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "gpu": smi, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "kernel_build_s": build_s,
          "libraries": sorted(p.name for p in libs.values())})

    dev = torch.device("cuda")
    cfg = FPMConfig(max_illumination_na=0.45, iterations=10)
    geom = compute_geometry(cfg)
    obj_true = make_test_object(cfg.n_large, seed=args.seed)
    frames = simulate_images(obj_true, geom, cfg, quantize=True)
    k_leds, n, nl = geom.num_leds, cfg.np_size, cfg.n_large
    opts = epry.EPRYOptions.from_config(cfg, use_pallas=True)
    b, lo = kernels.bbox_extent(n, opts.pupil_radius)
    check((n, nl, k_leds, b, lo) == (90, 360, 193, 64, 15),
          f"unexpected mono shapes {(n, nl, k_leds, b, lo)}")

    amps, starts = epry._sorted_device_inputs(frames, geom, torch.complex64, dev)
    sup_r = torch.as_tensor(pupil_support(cfg), dtype=torch.float32, device=dev)
    o0, p0 = epry.init_traced(amps, sup_r, opts)
    o_planes = torch.stack([o0.real, o0.imag]).contiguous()
    p_planes = torch.stack([p0.real, p0.imag]).contiguous()
    opts_b = dataclasses.replace(opts, mode="batched", chunk_size=32)
    amps_it, starts_it, mask = epry._chunk_inputs(amps, starts, opts_b, torch.float32)
    valid = (mask > 0).reshape(-1).to(torch.int32)
    n_slots = int(valid.numel())
    common = dict(np_size=n, n_large=nl, delta1=cfg.delta1, delta2=cfg.delta2, eps=cfg.eps,
                  pupil_radius=opts.pupil_radius, collect_metrics=True)
    cases = {
        "K1": (kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain,
               (amps_it, starts_it.reshape(-1), valid), dict(pupil_step_scale=1.0)),
        "K2 exact": (kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                     (amps, starts.reshape(-1)), dict(global_max="exact")),
        "K2 lazy": (kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                    (amps, starts.reshape(-1)), dict(global_max="lazy")),
    }

    # --------------------------------------------------- 2. kernel_vs_plain
    outside = torch.as_tensor(pupil_support(cfg), device=dev) == 0
    errs = {}
    for name, (kern, plain, rest, extra) in cases.items():
        state = {"kernel": (o_planes, p_planes), "plain": (o_planes, p_planes)}
        mets = {"kernel": [], "plain": []}
        for _ in range(2):
            for route, fn in (("kernel", kern), ("plain", plain)):
                o, p, m = fn(*state[route], sup_r, *rest, **common, **extra)
                state[route] = (o, p)
                mets[route].append(m.tolist())
        torch.cuda.synchronize()
        (ok_, pk), (op_, pp_) = state["kernel"], state["plain"]
        rel_o = ((ok_ - op_).abs().max() / op_.abs().max()).item()
        rel_p = ((pk - pp_).abs().max() / pp_.abs().max()).item()
        max_abs = max((ok_ - op_).abs().max().item(), (pk - pp_).abs().max().item())
        mk, mp = np.array(mets["kernel"]), np.array(mets["plain"])
        rel_m = float(np.max(np.abs(mk - mp) / np.abs(mp)))
        leak = pk[:, outside].abs().max().item()
        errs[name] = max_abs
        emit({"phase": "kernel_vs_plain", "case": name, "sweeps": 2, "rel_err_o": rel_o,
              "rel_err_p": rel_p, "max_abs_err": max_abs, "metrics_rel_err": rel_m,
              "pupil_outside_support": leak,
              "limits": {"rel_o": TOL_O, "rel_p": TOL_P, "metrics_rtol": TOL_METRICS}})
        check(rel_o <= TOL_O and rel_p <= TOL_P and rel_m <= TOL_METRICS and leak == 0.0,
              f"{name} disagrees with its plain version")

    # --------------------------------------------------------- 3. main_path
    launches = {}
    with tempfile.TemporaryDirectory(prefix="fpm_chip_smoke_") as tmp:
        cfg_path = write_dataset(os.path.join(tmp, "data"), cfg, geom, frames)
        for mode, wrapper, key in (("batched", kernels.fused_epry_chunked, "K1"),
                                   ("sequential", kernels.fused_epry_sweep, "K2")):
            out = os.path.join(tmp, f"out_{mode}")
            kernels.fused_epry_chunked.launches = 0
            kernels.fused_epry_sweep.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["run", cfg_path, "-n", "10", "-o", out, "--use-pallas",
                           "--mode", mode, "--chunk-size", "32"])
            wall = time.perf_counter() - t0
            counts = {"K1": kernels.fused_epry_chunked.launches,
                      "K2": kernels.fused_epry_sweep.launches}
            launches[key] = wrapper.launches
            check(rc == 0, f"fpm_torch run --mode {mode} exited {rc}")
            check(wrapper.launches > 0, f"--mode {mode} launched no {key} kernel")
            missing = [f for f in OUTPUT_FILES if not os.path.exists(os.path.join(out, f))]
            check(not missing, f"--mode {mode} wrote no {missing}")
            obj = np.load(os.path.join(out, "object.npy"))
            check(obj.shape == (nl, nl) and np.isfinite(obj).all(),
                  f"--mode {mode}: object {obj.shape} not finite of shape {(nl, nl)}")
            rmse = amplitude_rmse(obj, obj_true)
            with open(os.path.join(out, "manifest.json")) as f:
                resid = json.load(f)["metrics"]["data_residual"]
            with open(os.path.join(out, "metrics.jsonl")) as f:
                phase_s = {r["name"]: r["seconds"] for r in map(json.loads, f)
                           if r["event"] == "phase"}
            # The same solve again in this process, warm (cuFFT plans and
            # libraries loaded): what a second reconstruction pays.
            warm_s = []
            for _ in range(2):
                t0 = time.perf_counter()
                epry.reconstruct(frames, geom, cfg, iterations=10, use_pallas=True,
                                 mode=mode, chunk_size=32)
                torch.cuda.synchronize()
                warm_s.append(time.perf_counter() - t0)
            emit({"phase": "main_path", "mode": mode, "iterations": 10, "wall_s": wall,
                  "phase_s": phase_s, "reconstruct_warm_s": warm_s[-1],
                  "launches": counts,
                  "amp_rmse": rmse, "rmse_limit": RMSE_LIMIT,
                  "data_residual_first_last": [resid[0], resid[-1]]})
            check(rmse < RMSE_LIMIT, f"--mode {mode} amplitude RMSE {rmse} >= {RMSE_LIMIT}")

    # ------------------------------------------------------------ 4. timing
    support_c = sup_r.to(torch.complex64)
    library = {
        "K1": lambda: epry.sweep_batched(o0, p0, amps_it, starts_it, support=support_c,
                                         opts=opts_b, mask=mask),
        "K2": lambda: epry.sweep_sequential(o0, p0, amps, starts, support=support_c,
                                            opts=opts),
    }
    rows = []
    for key, name, src, replaces in (
            ("K1", "fused_epry_chunked", "fpm_torch/ops/csrc/epry_chunked.cu",
             "fpm_tpu/ops/pallas_kernels.py:775"),
            ("K2", "fused_epry_sweep", "fpm_torch/ops/csrc/epry_sweep.cu",
             "fpm_tpu/ops/pallas_kernels.py:1131")):
        kern, plain, rest, extra = cases["K1" if key == "K1" else "K2 exact"]
        def sweep():
            return kern(o_planes, p_planes, sup_r, *rest, **common, **extra)

        kern.launches = 0
        sweep()
        per_sweep = kern.launches
        ms = cuda_ms(sweep, 5)
        by_kernel = device_ms_by_kernel(sweep)
        plain_ms = cuda_ms(lambda: plain(o_planes, p_planes, sup_r, *rest, **common, **extra), 2)
        library_ms = cuda_ms(library[key], 2)
        nbytes, flops = sweep_work(k_leds, n, b, nl, n_slots if key == "K1" else k_leds,
                                   has_valid=key == "K1")
        bound_ms, bound_by = bound(nbytes, flops)
        err = errs["K1"] if key == "K1" else max(errs["K2 exact"], errs["K2 lazy"])
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[key], "launches_per_sweep": per_sweep,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
        emit({"phase": "timing", "kernel": name, "ms_per_sweep": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "bytes": nbytes, "flops": flops, "launches_per_sweep": per_sweep,
              "led_frames_per_s": k_leds / ms * 1e3, "device_ms_by_kernel": by_kernel,
              "device_busy_share": sum(by_kernel.values()) / ms, "gpu": smi})

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
