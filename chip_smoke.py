#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fpm_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc``, ``cuobjdump`` and ``nvidia-smi``; it never
imports JAX or ``fpm_tpu``. On the mono dome problem
(``FPMConfig(max_illumination_na=0.45)``: Np=90, Nlarge=360, K=193 LEDs,
NA-disk bbox 64 at offset 15; object made from ``--seed``) it runs, each
phase printing one JSON line. Every kernel case runs at both precision
tiers of the DFT products (``dft_precision``): ``bf16x3``, the default (a
3-pass bf16 split on the tensor cores, ``fpm_tpu``'s default), and
``highest`` (FP32), each against the plain version at the same tier.

1. ``device``: the card's name and power limit (``nvidia-smi``), the torch
   version, the time to build the kernels from ``fpm_torch/ops/csrc`` (the
   main libraries and, in the same parallel ``nvcc`` runs, the ablation
   builds of K1 and K2, ``build.build_with_ablations``), ptxas's registers
   and spills of both, and the HMMA (tensor-core) instructions in each main
   kernel instantiation's SASS (``cuobjdump``): more than 0 in every bf16x3
   one, none in the highest ones.
   Then a ``digests`` line (``kernel_digests``): SHA-256 of K1, K2 and K3's
   results at Np 90 and 100, both tiers and cluster sizes 1-8, and under
   ``sharded`` of the spectrum and pupil after 2 sweeps of every sharded
   case of phase 5 (``sharded_digests``, public entry points only), for
   comparing two checkouts' bits on one card
   (``scripts/compare_checkouts.py``).
2. ``kernel_vs_plain``: K1 (chunk 32, strided) and K2 (exact and lazy max)
   against their plain PyTorch versions on the card, 2 sweeps from the same
   init state: rel-max |ΔO| ≤ 1e-5, rel-max |ΔP| ≤ 1e-4 (f32 against f32,
   differing only in summation order), metrics rtol 1e-4, and the kernels'
   pupil exactly 0 outside the NA support. Every kernel runs one LED on a
   thread-block cluster; each case runs at the cluster size the kernel's
   entry point chooses and at forced sizes 1 (one block per LED) and 2
   (blocks reading each other's shared memory), and K1 and K2 once more
   from the same state: bitwise equal. K3, one call each on the full
   block (R=360, chunk 0 of the chunk-32 schedule, init state) and on the
   two halo-extended tile blocks of tile=2 (R=180+90=270, each tile's
   workset of chunk 0 with block-relative starts and its padded slots
   masked, the state after one sweep), and on each at the slot count a rank
   of mesh (4,1) or (2,2) gives it on the main path: d ≤ 1e-5, v ≤
   1e-4, metrics rtol 1e-4, v exactly 0 outside the support, d exactly 0
   outside every valid window. The problem axis of K1 and K2: K2 (exact
   and lazy) and K1 (chunk 32) at P = 3, 16 and 140 problems in one launch
   (140 is more than one wave of the card), the problems being Np=90 ROIs
   of whole simulated 568×568 camera frames (the mono dome optics at
   np_size=568, NL=2272, object from ``--seed``, 16-bit frames; ROI origins
   34 px apart): every problem bitwise equal to its solo launch, problems 0
   and P−1 within the limits above of the plain version, and with problem
   1's frames set to NaN every other problem still bitwise equal to its
   solo launch; 2 launches per K2 sweep and 21 per K1 sweep, whatever P.
   At bf16x3 K3's ``d`` is held within the tier's own distance from FP32
   on the same call (see the note at ``TOL_O``). Then
   the proof that the three passes run: K2 at bf16x3 within 5e-5 (object) /
   5e-4 (pupil) of K2 at highest (tests/test_pallas.py's limits for the
   tier), where the plain sweep with one hi·hi pass per product is more
   than 1e-3 off.
3. ``sharded_vs_single``: 2 sweeps on meshes (led, tile) = (4,1), (2,2) and
   (1,8) (tile height 45 < Np: a two-hop halo), all ranks on the one card,
   against 2 sweeps of K1 single-device at chunk 32 from the same init (the
   chunk membership is the same, so only summation order differs): the same
   limits; and the collectives the mesh counted (calls, payload bytes)
   against the analytic model of ``fpm_torch.parallel.comm``: equal.
4. ``main_path``: the dataset written as TIFFs + ``dataset.json``, then
   ``python -m fpm_torch run ... -n 10 --use-pallas --chunk-size 32``
   (through ``fpm_torch.cli.main``) in ``batched`` and ``sequential`` mode
   and with ``--mesh 4 1`` and ``--mesh 2 2``; every kernel's launch counter
   starts at 0 before each run and only that run's kernel (K1, K2, K3, K3)
   must move; the output file set must be complete, the amplitude RMSE
   against the true object below 0.05, and a mesh run's ``metrics.jsonl``
   must record its mesh; the same three runs (batched, sequential, mesh
   (4,1)) once more with ``--dft-precision highest``, and every run's
   ``metrics.jsonl`` must record the tier it ran.
   ``large_fov``: the whole 568×568 frames as TIFFs with a ``dataset.json``
   at Np=90, then ``run ... -n 10 --use-pallas --fov-grid 8 8
   --checkpoint-every 1`` in sequential and batched mode: 64 ROI tiles at
   overlap 22 (stride 68) solved in rounds, the tiles of a round in one
   problem-axis launch per sweep; the kernel's launch counter must be its
   per-sweep count × 10 × rounds and no other counter may move; 64 ``tile``
   events, ``object_stitched.npy`` of 2264×2264 and its PNGs; every stored
   tile and the stitch bitwise equal to ``reconstruct_large_fov`` (tile
   after tile through ``reconstruct`` on the card, timed beside the ROI
   path); the stitched amplitude error against the true object
   (tests/test_largefov.py's formula, less the 88-px high-res overlap
   margin) below 0.3. Then half of ``out/tiles`` deleted and ``--resume``:
   the stitch bitwise that of the first run, ``tile`` events for the
   deleted tiles only.
   ``ingest``: the TIFFs of ``main_path`` (90×90 crops) and of ``large_fov``
   (568×568 whole frames) loaded through the native C++ decoder
   (``fpm_torch.native``, built here with ``g++``) and through PIL: which
   decoder ran, each path's seconds, the arrays bitwise equal; where the
   machine has ``g++`` the native path must run, and every ``run`` must
   record in ``metrics.jsonl`` that it decoded natively.
   ``rgb``: three objects (seeds ``seed``, ``seed+1``, ``seed+2``) in the
   planes of 8-bit RGB TIFFs of the mono dome frames, ``run ... -n 10
   --use-pallas --color-mode rgb`` in both modes: one launch sequence per
   sweep for all three channels, ``red/``, ``green/``, ``blue/`` and
   ``object_rgb.png`` written, each channel bitwise that channel solved
   alone by ``reconstruct``, amplitude RMSE below 0.05 per channel.
5. ``timing``: at each tier, per-sweep milliseconds of each kernel (through
   its wrapper), at the chosen cluster size and at forced sizes 1, 2, 4, 8;
   of its plain version on the card, and of the eager ``torch.fft`` route
   (``library_ms``); device milliseconds by kernel name (``torch.profiler``)
   and, for K2's one persistent launch, the share of each phase of an LED
   (``k2_phase_profile``, the kernel's cycle-counting build); the launches
   of one sweep, counted by the wrapper (K2: at most 2); and
   the least time the card could take (``bound_ms``: the work done as
   pruned FFTs plus its element-wise work, and its bytes, against the H100
   SXM peaks of 67 TFLOP/s FP32 and 3.35 TB/s; of the spectrum a K3 call
   must read only its valid LEDs' windows, while it writes d whole). K3 is
   timed per call and per sweep's worth of calls (7) as rank (0,0) of mesh
   (4,1) makes them (8 LED slots per call on the 360×360 block). K1 and K2
   with a problem axis at P = 1, 3, 16, 33, 66 and 132 (highest: P = 1
   and 66) at the cluster size the entry point picks: ms per sweep and per
   problem-sweep, LED-frames/s (ptxas's registers and spills of each
   instantiation are on the ``device`` line). K1 and K2 also give their
   device time with Z cut by rows across the cluster (the entry points keep
   Z whole in every block where it fits, as here).
   ``sharded_sweep`` lines, one per case of ``SHARDED_CASES`` (mono (4,1),
   (2,2), (1,8), dogStomach (2,2), mono (2,2) at highest and with the bf16
   wire), fresh and with ``--stale-consensus``, all ranks sharing the card
   (not scaling results): ms per sweep (each rank on its stream, the
   collectives on the mesh's lanes, the host pacing) with the card's busy
   share, ``overlap_ms`` (the time in which K3 and a reduction or copy on a
   lane run at once, from the trace of a sweep enqueued behind a gate, so
   that the card runs it unpaced: above 0 under the stale consensus,
   exactly 0 on fresh; each trace sees every K3 launch the wrapper
   counted, a trace that lost records taken again up to 3 times, its
   ``attempts`` printed), ``consensus_schedule_check`` on ``mesh.schedule`` (issued
   before compute under the stale consensus only), no host synchronisation
   inside a sweep (``set_sync_debug_mode("error")``), ms per sweep through
   the entry point (``sharded_entry_timing``: a run of 10 sweeps less one
   of 0), and bitwise: the ``digests`` line and 4 more runs, and the mesh
   with its streams serialized (``serialize_streams``).
6. ``dogstomach``: the dogStomach optics of tests/test_torch_np200.py
   (Np=200, NL=600, K=88 dome LEDs, bbox 112 at offset 48, object from
   ``--seed``, 16-bit frames; nothing cut). K2 exact and lazy, K1 at chunk 16
   (what the port runs, as fpm_tpu does) and 32, K3 on the full block and on
   tile 0's halo block as a rank of mesh (2,2) gets it, and K2, K1 and K3
   once more with the whole patch as the bbox (pupil_radius 0, b = n = 200,
   Z cut by rows), each at both tiers against the plain version (K3's d at
   ``k3_d_limit``, v at 1e-4, and the state they give the sweep, O + d and
   P + v/max|O + d|, at 1e-5 / 1e-4), bitwise
   repeated, at every forced cluster size (those that do not fit refused
   before any launch), and with the other layout of Z; each plan printed.
   Then ``run -n 10 --use-pallas --chunk-size 32`` in sequential and
   batched mode and with ``--mesh 2 2`` at both tiers (launches of that
   run's kernel only, every output file, amplitude RMSE below 0.05, the
   batched run recording chunk 16), and timing as in 5 with K2's phase
   profile. Then ``ablate=`` where Z is cut by rows (``dog_ablations``):
   every variant of K2 and of K1 (chunk 16) with the whole patch as the
   bbox (b = n = 200), at both tiers (dft-1pass at bf16x3 alone), one sweep
   from the init state against the plain version with the same ``ablate``
   at ABLATE_TOL's limits, its plan's ``zcut`` 1 and its launches, and
   ``ablate=""`` through the ablation build bitwise the main Z-cut kernel;
   then each variant's ns per LED (K2) or per slot (K1) from a short ladder
   of sweeps on CUDA events (DOG_ABLATE_LADDER, ``bench.ladder``).

7. ``oracle``: on the mono dome problem, 3 sweeps of K2 (sequential
   ``reconstruct``, kernel route) at both tiers against the port's float64
   NumPy oracle (``fpm_torch.oracle``, run on the card's machine): the
   judge metric (``complex_field_rmse``) of ``obj_crop`` and the rel-max of
   ``obj_f``, held to 1e-3 at highest (tests/test_torch_solver.py's bound
   of complex64 against the oracle); K2's launches only.
8. ``debug``: ``run --debug --debug-led 3 --use-pallas -n 3`` in sequential
   (K2) and batched (K1) mode on the card: the files under ``debug/`` equal
   those of the same command with ``--platform cpu``, ``object.npy`` within
   rel-max 1e-6 of the command without ``--debug`` on the card (whether
   bitwise is printed), only that mode's kernel launched; then
   ``led_intermediates`` replayed on the card against the CPU from one
   state, at positions 3 and the last: each of the six spectra within
   1e-10 (complex128) and 1e-4 (complex64).
9. ``distributed``: two processes started by this script (``FPM_*`` set,
   a free port on localhost), both on the one card, so their mesh's
   transport is gloo (checked from the mesh line): ``run --distributed
   --use-pallas -n 3`` with ``--mesh 2 1`` and ``--mesh 1 2`` (every halo
   crosses the processes), each once more with ``--comm-precision bf16
   --stale-consensus``: ``object_spectrum.npy`` and ``pupil.npy`` bitwise
   the one-process run of the same flags, K3 launched on both processes,
   each process's counted collectives equal to the one-process mesh's and
   to the model of ``parallel.comm``; ``--fov-grid 8 8 -n 10`` on the
   568×568 frames: ``object_stitched.npy`` bitwise the one-process run;
   process 1's output directory empty in every run; then ONE process over
   nccl (``--distributed --mesh 1 1``), bitwise its single-controller run.
   Wall seconds of every run.
10. ``bench``: ``ablate=`` of K1 (chunk 32) and K2 on the mono problem,
   every variant at both tiers, one sweep from the init state through the
   ablation build against the plain version with the same ``ablate``
   (omax-const from the state divided by max|O|, no-window-read with values
   at the spectrum's corner), at ABLATE_TOL's limits; the launches of each
   (K2 2, 1 without the row-max launch under omax-const; K1 21);
   ``ablate=""`` through the ablation build bitwise the kernel; and each
   variant with Z cut by rows (``force_z_layout`` 2) bitwise the same
   variant with Z whole, the plan this shape takes. Then
   ``fpm_torch.bench`` through its entry point in this process: one JSON
   line with every key of BENCH_KEYS, the card's name and power limit, and
   the amplitude RMSE after 10 sweeps below 0.05 (printed, with the
   secondary results of ``build/bench_secondary.json``); then the
   ``--ablate`` rows of both kernels on a short ladder (BENCH_ABLATE_LADDER).
11. ``benchmark``: every cell of ``BENCHMARK.json`` once through
   ``fpm_torch.bench.run_cell`` (what ``python -m fpm_torch.bench --cell
   <name>`` runs) on a short ladder (BENCH_CELL_LADDER) with BENCH_CELL_RUNS
   timed runs: the cell's line carries every metric ``BENCHMARK.json``
   names for it, each finite and above 0, ``correct`` true (the amplitude
   RMSE and the spectrum and pupil against the float64 reference on the
   CPU), the launches of the cell's kernel alone (K1 21 per sweep, K2 2),
   counted from 0 before each timed run, ``bound_share`` below 1, the card's
   name and power limit, a traced run whose trace holds every kernel it
   launched (``device_trace``); its breakdown has the cell's kernel among its
   top kernels; and the control, the cell's sweep loop with the one-pass
   product (``ablate`` dft-1pass), held to the same reference, comes out not
   correct.
12. ``surface``: the public solver functions of ``fpm_torch.models`` on
   the mono problem: ``init_state`` on the card within 1e-6 (rel-max) of
   the state ``reconstruct`` starts from (0 sweeps), and ``sweep_pallas``
   (K2) and ``sweep_batched_pallas`` (K1, chunk 32) at both tiers bitwise
   the kernel wrapper each calls on the same planes, only that kernel
   launched.

Then the ``kernels`` line (each kernel once per tier, the Np=200 rows
apart; the mono K1 and K2 rows name their ablation build, the Np=200 ones
their Z-cut ablation kernels with each variant's error and time), the
``nvidia-smi`` line, and the result line.
Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing anything.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

TOL_O, TOL_P, TOL_METRICS = 1e-5, 1e-4, 1e-4
# K3's d is a sum of object increments much smaller than the terms they come
# from (up − Oc∘P), and the tier's split is not a smooth function of its
# input (a last-bit change of a product's f32 result may move lo by one bf16
# step, 2^-17 of the value), so at bf16x3 the kernel's d is held no farther
# from the plain bf16x3 d than the tier itself lies from FP32 on the same
# call (plain bf16x3 against plain highest), and never tighter than TOL_O.
# At the dogStomach patch (Np 200) two f32 summation orders of d part by more
# than 1e-5 at either tier (the plain version on the card and on the CPU,
# 5e-5-1.7e-4), so there the plain version on the CPU is a witness too
# (k3_d_limit).
TOL_TIER_O, TOL_TIER_P, ONE_PASS_MIN = 5e-5, 5e-4, 1e-3
TIERS = ("bf16x3", "highest")     # the default first
RMSE_LIMIT = 0.05
STITCH_LIMIT = 0.3
AXIS_P = (3, 16, 140)             # problem counts held against solo launches
TIMING_P = (1, 3, 16, 33, 66, 132)
WIDE = 568                        # camera frame of the large-FOV and problem-axis phases
ROI_STEP = 34                     # origins of the problem-axis ROIs
OUTPUT_FILES = ("object.npy", "object_spectrum.npy", "pupil.npy", "object_amp.png",
                "object_phase.png", "pupil_amp.png", "pupil_phase.png",
                "manifest.json", "metrics.jsonl")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def k3_d_limit(plain_d, cpu_d, tier_d: float) -> float:
    """The limit on K3's d against the plain version's ``plain_d`` on the
    card: TOL_O, or how far two plain versions of d lie apart on the same
    call, whichever is larger: the plain version on the CPU (``cpu_d``,
    another f32 summation order) and, at bf16x3, the plain version at
    highest (``tier_d``, the tier's own distance from FP32; 0 at highest)."""
    return max(TOL_O, tier_d, rel(cpu_d, plain_d.cpu()))


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


def rel(a, b) -> float:
    """Max |a − b| relative to max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def instantiation_tier(name: str):
    """0 or 1: the tier of a kernel instantiation named in SASS (demangled,
    ``<(int)1>``, or mangled, ``ILi1E``); None for any other function."""
    m = re.search(r"<(?:\(int\))?([01])>|ILi([01])E", name)
    return None if m is None else int(m.group(1) or m.group(2))


def short_name(name: str) -> str:
    """``void fpm::k2_sweep<(int)1>(float *, ...)`` → ``fpm::k2_sweep<(int)1>``."""
    name = name.removeprefix("void ")
    return name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]


def write_dataset(out_dir, cfg, geom, frames) -> str:
    """The mono dome stack as ``iLED_<n>.tif`` frames plus ``dataset.json``
    (no background, ROI at the frame's corner; LED positions from the dome
    table). ``frames`` (K, H, W) uint16, or (K, H, W, 3) uint8 for RGB."""
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


def ingest_both(cfg, label: str, **kw):
    """The stack of ``cfg`` loaded as ``run`` loads it (the native decoder
    where it builds) and through PIL: one line with the decoder that ran,
    each path's seconds (the first includes the decoder's build), and
    whether the arrays are bitwise equal (checked). Where the machine has
    ``g++``, the native decoder must be the one that ran. Returns (the
    load, the decoder's name)."""
    import shutil

    import numpy as np

    from fpm_torch import native
    from fpm_torch.data.loader import load_dataset

    t0 = time.perf_counter()
    nat = load_dataset(cfg, **kw)
    decoder = nat.decoder
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = load_dataset(cfg, **kw)
    again_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pil = load_dataset(cfg, use_native=False, **kw)
    pil_s = time.perf_counter() - t0
    equal = all(np.array_equal(a.images, pil.images) and np.array_equal(a.bg_values,
                                                                       pil.bg_values)
                for a in (nat, again))
    emit({"phase": "ingest", "frames": label, "shape": list(nat.images.shape),
          "decoder": decoder, "fallback_files": nat.fallback_files,
          "native_build_error": native.build_error(),
          "ingest_s_first": native_s, "ingest_s": again_s, "ingest_s_pil": pil_s,
          "bitwise_equal": equal})
    check(equal, f"ingest of the {label}: the native and PIL arrays differ")
    if shutil.which("g++"):
        check(decoder == "native",
              f"ingest of the {label}: the native decoder did not run ({native.build_error()})")
    return nat, decoder


def read_records(out_dir) -> list[dict]:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def stitched_error(stitched, truth, margin: int) -> float:
    """tests/test_largefov.py's measure: the scale-aligned amplitude RMSE,
    normalized by the mean true amplitude, on the interior of the stitch
    less ``margin`` high-res pixels at each edge."""
    import numpy as np

    from fpm_torch.bench import amplitude_rmse

    h, w = stitched.shape
    sl = np.s_[margin:h - margin, margin:w - margin]
    return amplitude_rmse(stitched[sl], truth[:h, :w][sl])


# The dogStomach problem: tests/test_tpu_hw.py:110-117's optics on the
# built-in dome table, the reference's largest patch, which fpm_tpu runs on
# its chip: Np=200, NL=600, K=88, pupil radius 52, bbox 112 at offset 48.
DOG_OPTICS = dict(np_size=200, pixel_size=6.5, objective_mag=8.0, objective_na=0.2,
                  max_illumination_na=0.30, wavelength=0.63)
DOG_SHAPES = (200, 600, 88, 112, 48)      # (Np, NL, K, b, lo)
DOG_CHUNK_REQUESTED, DOG_CHUNK_RUN = 32, 16   # fpm_tpu's ceiling at Np 200 (F3)
FORCED_CS = (1, 2, 4, 8)


def kernel_digests(dev) -> dict:
    """SHA-256 of K1 (chunk 7), K2 (exact) and K3 (chunk 0 of the chunk-8
    schedule on the whole spectrum) on ``synthetic_dataset(np_size, grid=5,
    seed=3)`` at Np 90 and 100, both tiers and every forced cluster size: a
    fingerprint of the kernels' bits that two checkouts run on one card
    compare (import this module with the other checkout first on the path)."""
    import hashlib

    import numpy as np
    import torch

    from fpm_torch.data.simulate import synthetic_dataset
    from fpm_torch.geometry import pupil_support
    from fpm_torch.models import epry
    from fpm_torch.ops import kernels

    cases, total = {}, hashlib.sha256()
    for np_size in (90, 100):
        ds = synthetic_dataset(np_size=np_size, grid=5, seed=3)
        cfg = ds.cfg
        opts = epry.EPRYOptions.from_config(cfg, use_pallas=True, mode="batched", chunk_size=7)
        amps, starts = epry._sorted_device_inputs(ds.images, ds.geom, torch.complex64, dev)
        sup = torch.as_tensor(pupil_support(cfg), dtype=torch.float32, device=dev)
        o, p = epry.init_traced(amps, sup, opts)
        o, p = (torch.stack([z.real, z.imag]).contiguous() for z in (o, p))
        a_it, s_it, mask = epry._chunk_inputs(amps, starts, opts, torch.float32)
        k = amps.shape[0]
        perm, _, n_chunks = epry.chunk_schedule(k, 8, "strided")
        sel = perm.reshape(n_chunks, 8)[0]
        live = torch.as_tensor(sel < k, device=dev)
        pick = torch.as_tensor(np.where(sel < k, sel, 0), device=dev)
        calls_ = {
            "K1": (kernels.fused_epry_chunked,
                   (o, p, sup, a_it, s_it.reshape(-1), (mask > 0).reshape(-1).to(torch.int32)),
                   dict(n_large=cfg.n_large, pupil_step_scale=1.0)),
            "K2": (kernels.fused_epry_sweep, (o, p, sup, amps, starts.reshape(-1)),
                   dict(n_large=cfg.n_large, global_max="exact")),
            "K3": (kernels.fused_chunk_increments,
                   (o, p, sup, amps[pick] * live[:, None, None],
                    (starts[pick] * live[:, None].to(torch.int32)).reshape(-1).contiguous(),
                    live.to(torch.int32)),
                   dict(n_rows=cfg.n_large, n_cols=cfg.n_large)),
        }
        for tier in TIERS:
            kw = dict(np_size=np_size, delta1=cfg.delta1, delta2=cfg.delta2, eps=cfg.eps,
                      pupil_radius=opts.pupil_radius, collect_metrics=True, dft_precision=tier)
            for name, (fn, args, extra) in calls_.items():
                for cs in FORCED_CS:
                    fn.force_cluster_size = cs
                    try:
                        out = fn(*args, **kw, **extra)
                    finally:
                        fn.force_cluster_size = 0
                    h = hashlib.sha256()
                    for t in out:
                        h.update(t.detach().cpu().numpy().tobytes())
                    total.update(h.digest())
                    cases[f"{name} np {np_size} {tier} cs {cs}"] = h.hexdigest()[:16]
    return {"phase": "digests", "cases": cases, "all": total.hexdigest()}


# The sharded sweeps of the main path (``run --mesh L T --use-pallas``):
# (problem, led, tile, options) at chunk 32 (16 at Np 200, fpm_tpu's
# ceiling), each fresh and with the stale consensus, 2 sweeps.
SHARDED_CASES = (("mono", 4, 1, {}), ("mono", 2, 2, {}), ("mono", 1, 8, {}),
                 ("dogStomach", 2, 2, {}), ("mono", 2, 2, {"dft_precision": "highest"}),
                 ("mono", 2, 2, {"comm_precision": "bf16"}))
SHARDED_SWEEPS, SHARDED_REPEATS = 2, 5


def sharded_problem(name: str, seed: int = 0):
    """(cfg, geom, frames) of the mono dome or the dogStomach problem."""
    from fpm_torch.config import FPMConfig
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry

    cfg = (FPMConfig(max_illumination_na=0.45) if name == "mono"
           else FPMConfig(**DOG_OPTICS))
    geom = compute_geometry(cfg)
    return cfg, geom, simulate_images(make_test_object(cfg.n_large, seed=seed), geom, cfg,
                                      quantize=True)


def sharded_label(name: str, led: int, tile: int, options: dict, stale: bool) -> str:
    extra = "".join(f" {v}" for v in options.values())
    return f"{name} mesh {led} {tile}{extra}{' stale' if stale else ''}"


def sharded_run(problem, led: int, tile: int, options: dict, stale: bool,
                iterations: int = SHARDED_SWEEPS, **mesh_kw):
    """``iterations`` sweeps through the public entry point on
    ``make_mesh(led, tile)``, all ranks on the first card."""
    from fpm_torch.parallel import make_mesh, reconstruct_led_sharded, reconstruct_tile_sharded

    cfg, geom, frames = problem
    fn = reconstruct_led_sharded if tile == 1 else reconstruct_tile_sharded
    return fn(frames, geom, cfg, mesh=make_mesh(led, tile, **mesh_kw),
              iterations=iterations, use_pallas=True, chunk_size=32,
              stale_consensus=stale, **options)


def result_digest(res) -> str:
    """SHA-256 of a result's spectrum and pupil."""
    import hashlib

    h = hashlib.sha256(res.obj_f_centered.tobytes())
    h.update(res.pupil.tobytes())
    return h.hexdigest()[:16]


def sharded_digests(seed: int = 0) -> dict:
    """SHA-256 of the spectrum and pupil after 2 sweeps of every
    ``SHARDED_CASES`` case, fresh and stale: only public entry points, so
    that two checkouts compare on one card (import this module with the
    other checkout first on the path)."""
    problems = {name: sharded_problem(name, seed) for name in dict.fromkeys(
        c[0] for c in SHARDED_CASES)}
    return {sharded_label(name, led, tile, options, stale):
            result_digest(sharded_run(problems[name], led, tile, options, stale))
            for name, led, tile, options in SHARDED_CASES for stale in (False, True)}


ENTRY_SWEEPS = 10


def sharded_entry_timing(seed: int = 0, busy: bool = False) -> dict:
    """Per ``SHARDED_CASES`` case, fresh and stale, through the public entry
    point only (so that it runs on either checkout, as
    :func:`sharded_digests`): ms per sweep of a run of ``ENTRY_SWEEPS``
    sweeps less a run of 0 (medians of 3; set-up, the result's gather and
    transform are in both). With ``busy``, also the card's busy time per
    sweep, the same difference of one traced run of each
    (:func:`trace_overlap`), as a share of it."""
    import torch

    problems = {name: sharded_problem(name, seed) for name in dict.fromkeys(
        c[0] for c in SHARDED_CASES)}
    out = {}
    for name, led, tile, options in SHARDED_CASES:
        for stale in (False, True):
            def run(it):
                return sharded_run(problems[name], led, tile, options, stale, iterations=it)

            ms = {}
            for it in (0, ENTRY_SWEEPS):
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    run(it)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                ms[it] = median(walls)
            per_sweep = (ms[ENTRY_SWEEPS] - ms[0]) / ENTRY_SWEEPS
            row = {"ms_per_sweep": per_sweep, "ms_0_sweeps": ms[0],
                   f"ms_{ENTRY_SWEEPS}_sweeps": ms[ENTRY_SWEEPS]}
            if busy:
                device = (trace_overlap(lambda: run(ENTRY_SWEEPS))["busy_ms"]
                          - trace_overlap(lambda: run(0))["busy_ms"]) / ENTRY_SWEEPS
                row.update(device_ms_per_sweep=device, busy_share=device / per_sweep)
            out[sharded_label(name, led, tile, options, stale)] = row
    return out


def trace_overlap(fn, gate_ms: float = 0.0) -> dict:
    """One call of ``fn`` under ``torch.profiler``, read from its trace: the
    time in which a kernel of ``fpm_torch``'s library (K3) and a kernel or
    copy on a stream that runs no K3 (the mesh's comm and halo lanes) run at
    once (``overlap_ms``), the time in which K3 runs, in which the lanes
    work, and in which anything runs (``busy_ms``), the span from the first
    to the last of it, the K3 kernels seen, and the call's wall time to
    the end of its work (traced: the profiler slows the host). With ``gate_ms`` a spin
    kernel of that length on each card's current stream holds the cards
    first, so that every stream of the mesh waits until the host has
    enqueued the whole of ``fn`` and the card then runs it unpaced
    (``gate_held``: no gate had ended when the host was done; the spin
    kernels' own time is left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gate_ends = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # The trace has been seen to miss the first kernels that run in it:
        # short spin kernels, left out below, run first on every card.
        for card in range(torch.cuda.device_count()):
            with torch.cuda.device(card):
                for _ in range(4):
                    torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for card in range(torch.cuda.device_count() if gate_ms else 0):
            with torch.cuda.device(card):
                torch.cuda._sleep(int(gate_ms * 2e6))     # ≥ gate_ms at ≤ 2 GHz
                gate_ends.append(torch.cuda.Event())
                gate_ends[-1].record()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        held = bool(gate_ends) and not any(e.query() for e in gate_ends)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="fpm_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    every = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    work = [e for e in every if "spin_kernel" not in e["name"]]
    k3 = [e for e in work if e["cat"] == "kernel" and "fpm::" in e["name"]]

    def stream(e):
        return e["args"].get("device"), e["args"].get("stream")

    k3_streams = {stream(e) for e in k3}
    lanes = [e for e in work if stream(e) not in k3_streams]

    def union(evs):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def length(spans):
        return sum(b - a for a, b in spans)

    def meet(xs, ys):
        i = j = 0
        total = 0.0
        while i < len(xs) and j < len(ys):
            lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
            total += max(0.0, hi - lo)
            if xs[i][1] < ys[j][1]:
                i += 1
            else:
                j += 1
        return total

    u_k3, u_lanes, u_work = union(k3), union(lanes), union(work)
    return {"k3_ms": length(u_k3) / 1e3, "lane_ms": length(u_lanes) / 1e3,
            "overlap_ms": meet(u_k3, u_lanes) / 1e3, "busy_ms": length(u_work) / 1e3,
            "span_ms": (u_work[-1][1] - u_work[0][0]) / 1e3 if u_work else 0.0,
            "k3_streams": len(k3_streams),
            "k3_per_stream": sorted(sum(stream(e) == st for e in k3) for st in k3_streams),
            "lane_streams": len({stream(e) for e in lanes}),
            "kernels": len([e for e in work if e["cat"] == "kernel"]),
            "k3_kernels": len(k3), "gate_held": held, "enqueue_ms": enqueue_ms,
            "wall_ms": wall_ms}


def gated_trace(fn, ms: float) -> dict:
    """:func:`trace_overlap` of ``fn`` behind a gate of 10 times ``ms`` (its
    untraced time), 4 times longer while the gate has not held (the
    profiler slows the host's enqueue, by up to 15 times as seen)."""
    gate = 10 * ms + 50
    for _ in range(4):
        traced = trace_overlap(fn, gate_ms=gate)
        if traced["gate_held"]:
            break
        gate *= 4
    return dict(traced, gate_ms=gate)


TRACE_ATTEMPTS = 3


def complete_trace(take, k3_launches: int) -> dict:
    """``take()`` (a trace of one sweep) until the trace holds every K3
    launch the wrapper counted, at most TRACE_ATTEMPTS times: the profiler
    has been seen to lose the records of a few kernels on some streams of a
    sweep (6 of 84 K3 launches and 13 other kernels on two of four rank
    streams, once in the 48 traces of two runs on an H100; the wrapper's
    count and the gated trace of the same sweep had all 84). The last
    trace, with ``attempts``; the caller still checks that it saw every
    launch."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        traced = take()
        if traced["k3_kernels"] == k3_launches:
            break
    return dict(traced, attempts=attempt)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def sharded_sweep_phase(problems: dict, digests: dict, entry: dict, smi: str) -> None:
    """The ``sharded_sweep`` lines: every ``SHARDED_CASES`` case, fresh and
    stale, all ranks on the one card (not scaling results). On prepared
    grids: ms per sweep on the host's clock, synchronised, median of 5, with
    the card's busy share (the time in which a kernel runs in one traced
    sweep over that median), and ``overlap_ms``, the time K3 and the lanes'
    work run at once, from one sweep enqueued behind a gate so that the card
    runs it unpaced (``trace_overlap``); ``consensus_schedule_check`` on the
    schedule; one sweep under ``torch.cuda.set_sync_debug_mode("error")``.
    Through the entry point: ``sharded_entry_timing``. Bitwise: the
    ``digests`` line and ``SHARDED_REPEATS`` - 1 more runs, and the mesh
    with its streams serialized (the test-only ``serialize_streams``)."""
    import torch

    from fpm_torch.ops import kernels
    from fpm_torch.parallel import comm, led_shard, make_mesh, tile_shard

    k3 = kernels.fused_chunk_increments

    def wall_ms(fn):
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return median(walls), walls

    def no_sync(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return True

    for name, led, tile, options in SHARDED_CASES:
        cfg, geom, frames = problem = problems[name]
        for stale in (False, True):
            label = sharded_label(name, led, tile, options, stale)
            mesh = make_mesh(led, tile)
            kw = dict(use_pallas=True, chunk_size=32, stale_consensus=stale, **options)
            if tile == 1:
                route, sopts = led_shard.prepare_led_sharded(frames, geom, cfg, mesh, **kw)

                def sweep():
                    return led_shard._sharded_sweep(mesh, route, opts=sopts)
            else:
                route, sopts, s = tile_shard.prepare_tile_sharded(frames, geom, cfg, mesh, **kw)

                def sweep():
                    return tile_shard._tile_sweep(mesh, route, opts=sopts, s=s)
            k3.launches = 0
            sweep()
            torch.cuda.synchronize()
            per_sweep = k3.launches
            ms, walls = wall_ms(sweep)
            verdict = comm.consensus_schedule_check(mesh.schedule)
            paced = complete_trace(lambda: trace_overlap(sweep), per_sweep)
            gated = complete_trace(lambda: gated_trace(sweep, ms), per_sweep)
            unsynced = no_sync(sweep)
            base = digests[label]
            repeats = [result_digest(sharded_run(problem, led, tile, options, stale))
                       for _ in range(SHARDED_REPEATS - 1)]
            serialized = result_digest(sharded_run(problem, led, tile, options, stale,
                                                   serialize_streams=True))
            emit({"phase": "sharded_sweep", "case": label, "mesh": [led, tile],
                  "problem": name, "stale_consensus": stale, "options": options,
                  "ranks_share_one_card": True, "k3_launches_per_sweep": per_sweep,
                  "wall_ms": ms, "wall_ms_all": walls,
                  "busy_share": paced["busy_ms"] / ms,
                  "overlap_ms": gated["overlap_ms"], "span_ms_unpaced": gated["span_ms"],
                  "overlap_ms_host_paced": paced["overlap_ms"],
                  "trace_unpaced": gated, "trace_host_paced": paced,
                  "entry_point": entry[label],
                  "consensus_schedule_check": verdict,
                  "no_host_sync": unsynced, "digest": base,
                  "repeats_bitwise": sum(r == base for r in repeats) + 1,
                  "serialized_bitwise": serialized == base, "gpu": smi})
            check(verdict["issued_before_compute"] is stale,
                  f"{label}: issued before compute is not {stale}: {verdict}")
            check(gated["gate_held"],
                  f"{label}: the gate ended before the sweep was enqueued: {gated}")
            check(per_sweep > 0 and paced["k3_kernels"] == gated["k3_kernels"] == per_sweep,
                  f"{label}: K3 launched {per_sweep} times, traced {paced['k3_kernels']} "
                  f"and {gated['k3_kernels']}")
            check(gated["overlap_ms"] > 0 if stale else gated["overlap_ms"] == 0,
                  f"{label}: K3 beside a collective for {gated['overlap_ms']} ms: {gated}")
            check(all(r == base for r in repeats), f"{label}: repeats differ")
            check(serialized == base, f"{label}: serialized streams change the result")


def refusal(fn):
    """Runs ``fn``; the entry point's refusal text if it refused the shape
    before any launch (shared memory, or a cluster that cannot be resident),
    else None."""
    try:
        fn()
    except RuntimeError as e:
        if "shared memory" in str(e) or "cannot be resident" in str(e):
            return str(e)
        raise
    return None


def calls(fn, args, kw, sweeps_n):
    """``sweeps_n`` sweeps of K1 or K2 from the state in ``args`` (their
    (o, p) and the per-sweep metrics stacked), or one call of K3
    (``sweeps_n`` = 0); waits for the card."""
    import torch

    if sweeps_n == 0:
        out = fn(*args, **kw)
    else:
        state, mets = args[:2], []
        for _ in range(sweeps_n):
            o, p, m = fn(*state, *args[2:], **kw)
            state = (o, p)
            mets.append(m)
        out = (*state, torch.stack(mets))
    torch.cuda.synchronize()
    return out


def dogstomach(seed: int, smi: str, dev) -> list:
    """The dogStomach phases (module docstring, 6). Returns the Np 200 rows
    of the ``kernels`` line."""
    import dataclasses

    import numpy as np
    import torch

    from fpm_torch import cli
    from fpm_torch.bench import (amplitude_rmse, bound, increments_work, sweep_work,
                                 window_union)
    from fpm_torch.config import FPMConfig
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry, pupil_support
    from fpm_torch.models import epry
    from fpm_torch.ops import kernels
    from fpm_torch.parallel import led_shard, tile_shard

    t0 = time.perf_counter()
    cfg = FPMConfig(**DOG_OPTICS, iterations=10)
    geom = compute_geometry(cfg)
    obj_true = make_test_object(cfg.n_large, seed=seed)
    frames = simulate_images(obj_true, geom, cfg, quantize=True)
    sim_s = time.perf_counter() - t0
    k_leds, n, nl = geom.num_leds, cfg.np_size, cfg.n_large
    opts = epry.EPRYOptions.from_config(cfg, use_pallas=True)
    radius = opts.pupil_radius
    b, lo = kernels.bbox_extent(n, radius)
    check((n, nl, k_leds, b, lo) == DOG_SHAPES,
          f"unexpected dogStomach shapes {(n, nl, k_leds, b, lo)}")
    amps, starts = epry._sorted_device_inputs(frames, geom, torch.complex64, dev)
    sup = torch.as_tensor(pupil_support(cfg), dtype=torch.float32, device=dev)
    outside = sup == 0
    o0, p0 = epry.init_traced(amps, sup, opts)
    o_planes = torch.stack([o0.real, o0.imag]).contiguous()
    p_planes = torch.stack([p0.real, p0.imag]).contiguous()
    common = dict(np_size=n, n_large=nl, delta1=cfg.delta1, delta2=cfg.delta2, eps=cfg.eps,
                  collect_metrics=True)
    k3_common = {k: v for k, v in common.items() if k != "n_large"}
    emit({"phase": "dogstomach", "step": "setup", "np": n, "n_large": nl, "leds": k_leds,
          "bbox": b, "bbox_offset": lo, "pupil_radius": radius,
          "frames": list(frames.shape), "sim_s": sim_s})

    chunked = {}
    for c in (DOG_CHUNK_RUN, DOG_CHUNK_REQUESTED):   # the kernel called directly at both
        a_c, s_c, m_c = epry.chunk_permute(amps, starts, c, "strided", torch.float32)
        chunked[c] = (a_c, s_c.reshape(-1), (m_c > 0).reshape(-1).to(torch.int32))
    # K3 on the full block (chunk 0 of the chunk-16 schedule, init state) and
    # on the halo-extended block of tile 0 of 2 as rank (0, 0) of mesh (2,2)
    # gets it (chunk 16 over 2 LED ranks, the state after one K1 sweep). Every
    # patch starts in rows 126-274, so tile 1's ranks get masked slots only.
    o1, p1, _ = kernels.fused_epry_chunked(o_planes, p_planes, sup, *chunked[DOG_CHUNK_RUN],
                                          **common, pupil_radius=radius, pupil_step_scale=1.0)
    a16, s16, v16 = chunked[DOG_CHUNK_RUN]
    k3_blocks = {"K3 full block": (o_planes, p_planes, a16[0], s16[:2 * DOG_CHUNK_RUN],
                                   v16[:DOG_CHUNK_RUN])}
    ring = torch.cat([o1, o1[:, :n]], dim=1)           # the halo wraps the ring
    idx, tile_s = tile_shard.partition_leds_by_tile(geom, nl, 2, 2, n,
                                                    chunk_size=DOG_CHUNK_RUN)
    check(int((idx[:, :, 1] >= 0).sum()) == 0, "a dogStomach patch starts in tile 1")
    for ti in (0,):
        sel = torch.as_tensor(idx[0, 0, ti], device=dev)
        live = sel >= 0
        check(int(live.sum()) > 1, f"dogStomach tile {ti}'s workset has too few LEDs")
        starts_rel = (starts[sel.clamp(min=0)] - torch.tensor(
            [ti * tile_s, 0], dtype=torch.int32, device=dev)) * live[:, None]
        k3_blocks[f"K3 tile block {ti}, rank of mesh (2,2)"] = (
            ring[:, ti * tile_s:(ti + 1) * tile_s + n].contiguous(), p1,
            amps[sel.clamp(min=0)] * live[:, None, None],
            starts_rel.to(torch.int32).reshape(-1).contiguous(), live.to(torch.int32))
    del o1, p1, ring

    # (name, wrapper, plain version, operands, sweeps (0: one K3 call),
    # options, LED slots of a launch); the full-bbox cases (pupil_radius 0:
    # b = n = 200 at lo 0) after the dogStomach bbox.
    def k3_case(name, blk, rad, tag=""):
        return (name + tag, kernels.fused_chunk_increments, kernels.fused_chunk_increments_plain,
                (blk[0], blk[1], sup, *blk[2:]), 0,
                dict(k3_common, n_rows=blk[0].shape[1], n_cols=blk[0].shape[2],
                     pupil_radius=rad), int(blk[4].numel()))

    cases = []
    for rad, tag in ((radius, ""), (0, ", full bbox")):
        cases.append((f"K2 exact{tag}", kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                      (o_planes, p_planes, sup, amps, starts.reshape(-1)), 2,
                      dict(common, global_max="exact", pupil_radius=rad), 1))
        if not tag:
            cases.append(("K2 lazy", kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain,
                          (o_planes, p_planes, sup, amps, starts.reshape(-1)), 2,
                          dict(common, global_max="lazy", pupil_radius=rad), 1))
        for c in (DOG_CHUNK_RUN,) if tag else (DOG_CHUNK_RUN, DOG_CHUNK_REQUESTED):
            cases.append((f"K1 chunk {c}{tag}", kernels.fused_epry_chunked,
                          kernels.fused_epry_chunked_plain, (o_planes, p_planes, sup, *chunked[c]),
                          2, dict(common, pupil_step_scale=1.0, pupil_radius=rad), c))
        for name, blk in k3_blocks.items():
            if not tag or name == "K3 full block":
                cases.append(k3_case(name, blk, rad, tag))

    # Each case at each tier: the kernel at the chosen plan against the plain
    # version, once more (bitwise), and at every forced cluster size: bitwise
    # the chosen plan's result where one block's buffers fit and a cluster can
    # be resident (resident_clusters, the entry point's own reckoning),
    # refused before any launch where not; at each forced size above 1 also
    # with the other layout of Z (whole in every block, or cut by rows),
    # bitwise or refused. K3's d is held at k3_d_limit (beside it the two
    # witnesses: the plain version at the other tier and on the CPU), its v
    # at TOL_P, and also what the sharded sweep makes of them, O + d and
    # P + v / max|O + d|, against the same from the plain version (TOL_O /
    # TOL_P, K1's limits).
    def applied(args, out):
        o = args[0] + out[0]
        return o, args[1] + out[1] / (o[0] * o[0] + o[1] * o[1]).max().sqrt()

    def forced_run(kern, args, kw, sweeps_n, cs, layout):
        """(refusal text, result, plan) of one call at a forced plan."""
        out = []
        kern.force_cluster_size, kern.force_z_layout = cs, layout
        try:
            why = refusal(lambda: out.append(calls(kern, args, kw, sweeps_n)))
        finally:
            kern.force_cluster_size = kern.force_z_layout = 0
        return why, (out[0] if out else None), dict(kern.plan)

    errs, plans = {}, {}
    for tier in TIERS:
        for name, kern, plain, args, sweeps_n, kw, slots in cases:
            kw = dict(kw, dft_precision=tier)
            probe = kernels.fused_epry_sweep if kern is kernels.fused_epry_sweep \
                else kernels.fused_epry_chunked        # K1 and K3 share chunk_forward
            got = []
            why = refusal(lambda: got.append(calls(kern, args, kw, sweeps_n)))
            if why:
                emit({"phase": "dogstomach", "case": name, "dft_precision": tier,
                      "refused": why})
                check(False, f"dogStomach {name} {tier} refused: {why}")
                continue
            got = got[0]
            plans[name, tier] = dict(kern.plan)
            want = calls(plain, args, kw, sweeps_n)
            line, increments_ok = {}, True
            if sweeps_n == 0:
                other = "highest" if tier == "bf16x3" else "bf16x3"
                wit_tier = plain(*args, **dict(kw, dft_precision=other))
                wit_cpu = plain(*(t.cpu() for t in args), **kw)
                for i, key in ((0, "d"), (1, "v")):
                    line[f"rel_err_{key}"] = rel(got[i], want[i])
                    line[f"plain_{key}_vs_plain_{other}"] = rel(want[i], wit_tier[i])
                    line[f"plain_{key}_card_vs_cpu"] = rel(want[i].cpu(), wit_cpu[i])
                    line[f"kernel_{key}_vs_plain_cpu"] = rel(got[i].cpu(), wit_cpu[i])
                line["limit_d"] = k3_d_limit(
                    want[0], wit_cpu[0],
                    line["plain_d_vs_plain_highest"] if tier == "bf16x3" else 0.0)
                increments_ok = (line["rel_err_d"] <= line["limit_d"]
                                 and line["rel_err_v"] <= TOL_P)
                b_c, lo_c = kernels.bbox_extent(n, kw["pupil_radius"])
                covered = torch.zeros(args[0].shape[1:], dtype=torch.bool, device=dev)
                for (y, x), ok in zip(args[4].view(-1, 2).tolist(), args[5].tolist()):
                    if ok:
                        covered[y + lo_c:y + lo_c + b_c, x + lo_c:x + lo_c + b_c] = True
                line["d_outside_windows"] = got[0][:, ~covered].abs().max().item()
                got_s, want_s = applied(args, got), applied(args, want)
            else:
                got_s, want_s = got[:2], want[:2]
            rel_a, rel_b = rel(got_s[0], want_s[0]), rel(got_s[1], want_s[1])
            mets_err = ((got[2] - want[2]).abs() / want[2].abs()).max().item()
            max_abs = max((got[0] - want[0]).abs().max().item(),
                          (got[1] - want[1]).abs().max().item())
            leak = got[1][..., outside].abs().max().item()
            errs[name, tier] = max_abs
            repeat_equal = all(torch.equal(x, y)
                               for x, y in zip(calls(kern, args, kw, sweeps_n), got))
            forced = {}
            for cs in FORCED_CS:
                count = []
                smem_why = refusal(lambda: count.append(kernels.resident_clusters(
                    probe, n, kw["pupil_radius"], slots, cs, dft_precision=tier)))
                resident = 0 if smem_why else count[0]
                launched = kern.launches
                why, out, plan = forced_run(kern, args, kw, sweeps_n, cs, 0)
                if why:
                    forced[str(cs)] = {"refused": why, "resident_clusters": resident}
                    check(resident == 0 and kern.launches == launched,
                          f"dogStomach {name} {tier}: cs {cs} refused though {resident} "
                          "clusters fit, or a refused call launched")
                    continue
                same = all(torch.equal(x, y) for x, y in zip(out, got))
                forced[str(cs)] = {"plan": plan, "resident_clusters": resident,
                                   "bitwise_equal_to_chosen": same}
                check(resident > 0 and same and plan["cs"] == cs,
                      f"dogStomach {name} {tier} at forced cs {cs}: not bitwise the chosen "
                      f"plan's result, or ran where {resident} clusters fit")
                if cs > 1:   # the other layout of Z
                    layout = 1 if plan["zcut"] else 2
                    why, out, plan = forced_run(kern, args, kw, sweeps_n, cs, layout)
                    same = why is None and all(torch.equal(x, y) for x, y in zip(out, got))
                    forced[f"{cs}, Z {'cut' if layout == 2 else 'whole'}"] = (
                        {"refused": why} if why else
                        {"plan": plan, "bitwise_equal_to_chosen": same})
                    check(why or same, f"dogStomach {name} {tier} at cs {cs} with the other "
                          "layout of Z is not bitwise the chosen plan's result")
            emit({"phase": "dogstomach", "case": name, "dft_precision": tier,
                  "plan": plans[name, tier], "sweeps": sweeps_n, "slots": slots,
                  ("rel_err_o_plus_d" if sweeps_n == 0 else "rel_err_o"): rel_a,
                  ("rel_err_p_plus_v" if sweeps_n == 0 else "rel_err_p"): rel_b,
                  "metrics_rel_err": mets_err, "max_abs_err": max_abs,
                  "pupil_outside_support": leak, "repeat_bitwise_equal": repeat_equal,
                  "forced": forced, **line,
                  "limits": {"rel_o": TOL_O, "rel_p": TOL_P, "metrics_rtol": TOL_METRICS}})
            check(rel_a <= TOL_O and rel_b <= TOL_P and mets_err <= TOL_METRICS
                  and increments_ok and leak == 0.0
                  and line.get("d_outside_windows", 0.0) == 0.0 and repeat_equal,
                  f"dogStomach {name} {tier} disagrees with its plain version or its repeat")

    # The CLI's three modes at both tiers: sequential (K2), batched with
    # --chunk-size 32 asked (K1 at the chunk fpm_tpu runs, 16) and --mesh 2 2
    # (K3), each with every counter at 0 before it and only its kernel moving.
    wrappers = {"K1": kernels.fused_epry_chunked, "K2": kernels.fused_epry_sweep,
                "K3": kernels.fused_chunk_increments}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="fpm_chip_smoke_dog_") as tmp:
        cfg_path = write_dataset(os.path.join(tmp, "data"), cfg, geom, frames)
        runs = (("sequential", ["--mode", "sequential"], "K2"),
                ("batched", ["--mode", "batched"], "K1"),
                ("mesh 2 2", ["--mesh", "2", "2"], "K3"))
        for tier in TIERS:
            for label, flags, key in runs:
                out = os.path.join(tmp, f"out_{label.replace(' ', '_')}_{tier}")
                for w in wrappers.values():
                    w.launches = 0
                t0 = time.perf_counter()
                rc = cli.main(["run", cfg_path, "-n", "10", "-o", out, "--use-pallas",
                               "--chunk-size", str(DOG_CHUNK_REQUESTED), "--dft-precision",
                               tier, *flags])
                wall = time.perf_counter() - t0
                counts = {k: w.launches for k, w in wrappers.items()}
                launches[key, tier] = counts[key]
                check(rc == 0, f"dogStomach run {label} {tier} exited {rc}")
                missing = [f for f in OUTPUT_FILES if not os.path.exists(os.path.join(out, f))]
                obj = np.load(os.path.join(out, "object.npy"))
                rmse = amplitude_rmse(obj, obj_true)
                records = read_records(out)
                options = next(r for r in records if r["event"] == "solver_options")
                run_decoder = next(r for r in records if r["event"] == "dataset")["decoder"]
                emit({"phase": "dogstomach", "run": label, "dft_precision": tier,
                      "iterations": 10, "wall_s": wall,
                      "phase_s": {r["name"]: r["seconds"] for r in records
                                  if r["event"] == "phase"},
                      "launches": counts, "plan": dict(wrappers[key].plan),
                      "recorded_chunk_size": options["chunk_size"],
                      "recorded_mesh": options["mesh"], "decoder": run_decoder,
                      "amp_rmse": rmse,
                      "rmse_limit": RMSE_LIMIT})
                check(not missing, f"dogStomach run {label} {tier} wrote no {missing}")
                check(counts[key] > 0 and all(c == 0 for k, c in counts.items() if k != key),
                      f"dogStomach run {label} {tier}: launches {counts}")
                check(obj.shape == (nl, nl) and np.isfinite(obj).all(),
                      f"dogStomach run {label} {tier}: object {obj.shape} not finite")
                check(options["dft_precision"] == tier, f"dogStomach run {label} recorded "
                      f"dft_precision {options['dft_precision']}")
                check(label != "batched" or options["chunk_size"] == DOG_CHUNK_RUN,
                      f"dogStomach batched run recorded chunk {options['chunk_size']}, "
                      f"not fpm_tpu's {DOG_CHUNK_RUN}")
                check(rmse < RMSE_LIMIT,
                      f"dogStomach run {label} {tier}: amplitude RMSE {rmse} >= {RMSE_LIMIT}")

    # Timing at each tier: through the wrapper (CUDA events), device ms by
    # kernel (torch.profiler), the plain version, the eager torch.fft route
    # (library_ms) and the bound; K2's phase profile at the chosen cs.
    support_c = sup.to(torch.complex64)
    eager = dataclasses.replace(opts, use_pallas=False)
    m16 = epry.chunk_permute(amps, starts, DOG_CHUNK_RUN, "strided", torch.float32)
    tile0 = k3_blocks["K3 tile block 0, rank of mesh (2,2)"]
    library_ms = {
        "K2": cuda_ms(lambda: epry.sweep_sequential(o0, p0, amps, starts, support=support_c,
                                                    opts=eager), 1),
        "K1": cuda_ms(lambda: epry.sweep_batched(o0, p0, m16[0], m16[1], support=support_c,
                                                 opts=eager, mask=m16[2]), 1),
        "K3": cuda_ms(lambda: led_shard._chunk_increments(
            torch.complex(tile0[0][0], tile0[0][1]), torch.complex(tile0[1][0], tile0[1][1]),
            support_c, tile0[2], tile0[3].view(-1, 2), tile0[4].to(torch.float32),
            opts=eager), 3),
    }
    by_name = {c[0]: c for c in cases}
    timed = (("K2", "K2 exact", "fused_epry_sweep", "epry_sweep.cu", ":1131"),
             ("K1", f"K1 chunk {DOG_CHUNK_RUN}", "fused_epry_chunked", "epry_chunked.cu", ":775"),
             ("K3", "K3 tile block 0, rank of mesh (2,2)", "fused_chunk_increments",
              "epry_increments.cu", ":1006"))
    n_valid = int(tile0[4].sum())
    o_elems = window_union(tile0[3].view(-1, 2).tolist(), tile0[4].tolist(), n, b, lo,
                           tile0[0].shape[1], tile0[0].shape[2])
    rows = []
    for tier in TIERS:
        for key, case, name, src, line in timed:
            _, kern, plain, args, sweeps_n, kw, slots = by_name[case]
            kw = dict(kw, dft_precision=tier)

            def once(fn=kern):
                return fn(*args, **kw)

            kern.launches = 0
            once()
            per_call, plan = kern.launches, dict(kern.plan)
            ms = cuda_ms(once, 5 if key != "K2" else 3)
            by_kernel = device_ms_by_kernel(once)
            other = []                                  # the other layout of Z, if it fits
            kern.force_z_layout = 2 - plan["zcut"]
            try:
                refusal(lambda: other.append(sum(device_ms_by_kernel(once).values())))
            finally:
                kern.force_z_layout = 0
            device_other = other[0] if other else None
            plain_ms = cuda_ms(lambda: once(plain), 1)
            if key == "K3":
                nbytes, flops = increments_work(n_valid, slots, n, b, tile0[0].shape[1],
                                                tile0[0].shape[2], o_elems)
            else:
                nbytes, flops = sweep_work(k_leds, n, b, nl, k_leds if key == "K2"
                                           else int(args[-1].numel()), has_valid=key == "K1")
            bound_ms, bound_by = bound(nbytes, flops)
            err = max(v for (c, t), v in errs.items() if c.startswith(key) and t == tier)
            rows.append({"name": f"{name} [{tier}, Np 200]", "dft_precision": tier,
                         "route": "cuda", "source": f"fpm_torch/ops/csrc/{src}",
                         "replaces": f"fpm_tpu/ops/pallas_kernels.py{line}",
                         "launches": launches[key, tier], "cluster_size": plan["cs"],
                         "max_abs_err": err, "ms": ms, "device_ms": sum(by_kernel.values()),
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms[key]})
            emit({"phase": "dogstomach", "step": "timing", "kernel": name, "dft_precision": tier,
                  "as": case, "plan": plan, "launches_per_call": per_call,
                  ("ms_per_call" if key == "K3" else "ms_per_sweep"): ms,
                  "device_ms_by_kernel": by_kernel,
                  f"device_ms_z_{'whole' if plan['zcut'] else 'cut_by_rows'}": device_other,
                  "plain_ms": plain_ms, "library_ms": library_ms[key], "bound_ms": bound_ms,
                  "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                  "led_frames_per_s": None if key == "K3" else k_leds / ms * 1e3, "gpu": smi})
        _, _, _, args, _, kw, _ = by_name["K2 exact"]
        kw = dict(kw, dft_precision=tier)
        kernels.k2_phase_profile(*args, **kw)              # built and warm
        (po, pp, _), cycles = kernels.k2_phase_profile(*args, **kw)
        ko, kp, _ = kernels.fused_epry_sweep(*args, **kw)
        check(torch.equal(po, ko) and torch.equal(pp, kp),
              f"dogStomach: K2's profile build gives another result ({tier})")
        total = sum(cycles.values())
        emit({"phase": "dogstomach", "step": "timing", "kernel": "fused_epry_sweep",
              "dft_precision": tier, "k2_phase_profile": {
                  "cluster_size": kernels.fused_epry_sweep.cluster_size, "leds": k_leds,
                  "cycles_per_led": total / k_leds,
                  "share_by_phase": {p: c / total for p, c in cycles.items()},
                  "cycles_per_led_by_phase": {p: c / k_leds for p, c in cycles.items()}},
              "gpu": smi})
    zcut = dog_ablations(cfg, geom, frames, by_name, smi)
    for row in rows:
        for key, name in (("K1", "fused_epry_chunked"), ("K2", "fused_epry_sweep")):
            if row["name"].startswith(name + " "):
                row["ablation_build"] = zcut[key]
    return rows


DOG_ABLATE_LADDER = (2, 6, 2)   # lo, hi sweeps, reps of the Np 200 b = n ablation rows


def ablation_state(args, ablate, b, seed=0):
    """The operands a variant of K1 or K2 runs from, ``args`` = (o, p, sup,
    amps, ...): divided by max|O| with the frames for omax-const (its max|O|
    is 1 + k), with values at the spectrum's corner for no-window-read (0 in
    the init state), else ``args``."""
    import torch

    o = args[0]
    if ablate == "omax-const":
        scale = (o[0] ** 2 + o[1] ** 2).max().rsqrt()
        return (o * scale, *args[1:3], args[3] * scale, *args[4:])
    if ablate == "no-window-read":
        noise = torch.randn((2, b, b), generator=torch.Generator().manual_seed(seed))
        corner = o.clone()
        corner[:, :b, :b] += 0.01 * o.abs().max() * noise.to(o.device)
        return (corner, *args[1:])
    return args


def ablation_names(key: str, tier: str) -> list:
    """The variants of K1 or K2 run at ``tier`` (dft-1pass at bf16x3 alone
    where the Z-cut kernels are held)."""
    from fpm_torch.ops import kernels

    names = kernels.CHUNKED_ABLATIONS if key == "K1" else kernels.SWEEP_ABLATIONS
    return [a for a in names if a != "dft-1pass" or tier == "bf16x3"]


def dog_ablations(cfg, geom, frames, by_name: dict, smi: str) -> dict:
    """``ablate=`` where Z is cut by rows (module docstring, 6): every
    variant of K1 (chunk 16) and K2 at the dogStomach optics with the whole
    patch as the bbox (b = n = 200), at both tiers (dft-1pass at bf16x3
    alone): one sweep from the init state against the plain version with
    the same ``ablate`` at ABLATE_TOL, the plan's zcut 1, its launches, and
    ``ablate=""`` through the ablation build bitwise the main Z-cut kernel;
    then ns per LED (K2) or per slot (K1) from a ladder of sweeps on CUDA
    events (``bench.ladder``, as ``fpm_torch.bench --ablate`` takes its
    rows) at the cluster size the kernel takes. Returns per kernel what the
    Np 200 rows of the ``kernels`` line say of the Z-cut ablation kernels."""
    import torch

    from fpm_torch import bench
    from fpm_torch.ops import build, kernels

    t0 = time.perf_counter()
    summary = {}
    for key, case, mode in (("K2", "K2 exact, full bbox", "sequential"),
                            ("K1", f"K1 chunk {DOG_CHUNK_RUN}, full bbox", "batched")):
        _, kern, plain, args, _, kw, _ = by_name[case]
        b = kernels.bbox_extent(cfg.np_size, kw["pupil_radius"])[0]
        check(b == cfg.np_size, f"dogStomach {case}: bbox {b}, not the whole patch")
        worst, ns_by = {}, {}
        for tier in TIERS:
            kw_t = dict(kw, dft_precision=tier)
            main = kern(*args, **kw_t)                   # the main Z-cut kernel
            check(kern.plan["zcut"] == 1, f"dogStomach {case} {tier}: Z not cut {kern.plan}")
            solve = bench.solver(cfg, geom, frames, "cuda", pupil_radius=0, dft_precision=tier,
                                 mode=mode, chunk_size=DOG_CHUNK_REQUESTED)
            per_sweep = (2 if key == "K2" else
                         3 * int(args[3].shape[0]))       # K1: three launches a chunk
            for ablate in ablation_names(key, tier):
                state = ablation_state(args, ablate, b)
                kern.launches = 0
                go, gp, gm = kern(*state, **kw_t, ablate=ablate)
                launched, plan = kern.launches, dict(kern.plan)
                po, pp, pm = plain(*state, **kw_t, ablate=ablate)
                torch.cuda.synchronize()
                tol_o, tol_p, tol_m = ABLATE_TOL.get(ablate, (TOL_O, TOL_P, TOL_METRICS))
                rel_o, rel_p = rel(go, po), rel(gp, pp)
                m_ok = bool(((gm - pm).abs() <= tol_m * pm.abs()).all())
                label = ablate or "(full)"
                worst[label] = max(worst.get(label, 0.0), (go - po).abs().max().item(),
                                   (gp - pp).abs().max().item())
                bitwise = None
                if not ablate:
                    kern.force_ablation_build = True
                    try:
                        ao, ap, am = kern(*state, **kw_t)
                    finally:
                        kern.force_ablation_build = False
                    bitwise = bool(torch.equal(ao, main[0]) and torch.equal(ap, main[1])
                                   and torch.equal(am, main[2]) and kern.plan["zcut"] == 1)
                # Timing: the ablation build (for "" too), at the chosen cs.
                sweep = solve.sweeps(ablate)
                row = {}
                try:
                    if not ablate:
                        sec, _ = bench.ladder(bench.cuda_clock(sweep, solve.state),
                                              *DOG_ABLATE_LADDER)
                        row["main_build_ns"] = sec * 1e9 / solve.n_slots
                    kern.force_ablation_build = True
                    sweep(solve.state)
                    kern.force_cluster_size = kern.cluster_size
                    sec, info = bench.ladder(bench.cuda_clock(sweep, solve.state),
                                             *DOG_ABLATE_LADDER)
                finally:
                    kern.force_cluster_size = 0
                    kern.force_ablation_build = False
                ns = sec * 1e9 / solve.n_slots
                ns_by.setdefault(tier, {})[label] = ns
                unit = "ns_per_led" if key == "K2" else "ns_per_slot"
                emit({"phase": "dogstomach", "step": "ablate_zcut", "kernel": key,
                      "dft_precision": tier, "ablate": label, "bbox": b, "sweeps": 1,
                      "rel_err_o": rel_o, "rel_err_p": rel_p,
                      "metrics": [gm.tolist(), pm.tolist()], "limits": [tol_o, tol_p, tol_m],
                      "launches": launched, "plan": plan,
                      "ablation_build_bitwise_main_zcut": bitwise, unit: ns,
                      "slots": solve.n_slots, "ladder": DOG_ABLATE_LADDER,
                      "degenerate": info["degenerate"], **row, "gpu": smi})
                check(plan["zcut"] == 1, f"dogStomach {key} ablate={ablate!r} {tier}: Z not "
                      f"cut by rows: {plan}")
                check(rel_o <= tol_o and rel_p <= tol_p and m_ok,
                      f"dogStomach {key} ablate={ablate!r} {tier} (Z cut) is off its plain "
                      f"version: {rel_o}, {rel_p}, metrics {gm.tolist()} vs {pm.tolist()}")
                want = per_sweep - (ablate == "omax-const" and key == "K2")
                check(launched == want,
                      f"dogStomach {key} ablate={ablate!r}: {launched} launches, not {want}")
                check(bitwise is not False, f"dogStomach {key}: ablate='' through the "
                      "ablation build is not bitwise the main Z-cut kernel")
        stem = "epry_chunked" if key == "K1" else "epry_sweep"
        summary[key] = {
            "library": build.ablation_library(stem)._name.rsplit("/", 1)[-1],
            "kernel": "chunk_forward_ablate_zcut" if key == "K1" else "k2_sweep_ablate_zcut",
            "as": f"{case}, Z cut by rows", "zcut": 1,
            "variants": ablation_names(key, "bf16x3"), "max_abs_err_by_variant": worst,
            ("ns_per_slot" if key == "K1" else "ns_per_led"): ns_by,
            "empty_bitwise_main_zcut": True}
    emit({"phase": "dogstomach", "step": "ablate_zcut_seconds",
          "seconds": time.perf_counter() - t0})
    return summary


# ------------------------------------------------ oracle, debug, distributed

# ``ablate=`` against the plain versions (phase 10): the kernels' limits,
# TOL_O / TOL_P / TOL_METRICS, where a variant forms the products as the
# kernel does or forms none (no-dft: within 4.3e-7 / 6.2e-7 of plain,
# NVIDIA H100 80GB HBM3, 700.00 W, this phase's lines). dft-1pass keeps 8
# bits of each operand of a product, so a last-bit difference between two
# summation orders of an operand can flip its bf16 rounding and move a
# product term by up to 2^-8 of it: up to 4.2e-5 / 5.0e-4 / 2.3e-5 (O / P /
# metrics, the same lines), held to 1e-4 / 2^-9 / 1e-4.
ABLATE_TOL = {"dft-1pass": (1e-4, 2.0 ** -9, 1e-4)}
# The keys of fpm_torch.bench's line.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_led_frames_per_s",
              "seconds_per_iteration", "device_ms_per_sweep", "busy_share", "bound_ms",
              "bound_by", "bound_share", "executed_tflops", "fft_stage_efficiency",
              "amp_rmse_10", "num_leds", "np_size", "n_large", "mode", "device")
BENCH_ABLATE_LADDER = (2, 12, 2)   # lo, hi sweeps, reps of phase 10's ablation rows


def bench_phase(seed: int, smi: str, o_planes, p_planes, sup, cases, common) -> dict:
    """10. ``ablate=`` and ``fpm_torch.bench`` (module docstring). Returns
    per kernel ("K1", "K2") what the ``kernels`` line says of its ablation
    build."""
    import torch

    from fpm_torch import bench
    from fpm_torch.ops import build, kernels

    t0 = time.perf_counter()
    n = common["np_size"]
    b, _ = kernels.bbox_extent(n, common["pupil_radius"])
    summary = {}
    for key, case in (("K1", "K1"), ("K2", "K2 exact")):
        kern, plain, rest, extra = cases[case]
        names = kernels.CHUNKED_ABLATIONS if key == "K1" else kernels.SWEEP_ABLATIONS
        worst = {}
        for tier in TIERS:
            for ablate in names:
                o, _, _, *args = ablation_state((o_planes, p_planes, sup, *rest), ablate, b,
                                                seed)
                kw = dict(common, **extra, dft_precision=tier, ablate=ablate)
                kern.launches = 0
                go, gp, gm = kern(o, p_planes, sup, *args, **kw)
                launched, plan = kern.launches, dict(kern.plan)
                po, pp, pm = plain(o, p_planes, sup, *args, **kw)
                torch.cuda.synchronize()
                tol_o, tol_p, tol_m = ABLATE_TOL.get(ablate, (TOL_O, TOL_P, TOL_METRICS))
                rel_o, rel_p = rel(go, po), rel(gp, pp)
                m_ok = bool(((gm - pm).abs() <= tol_m * pm.abs()).all())
                worst[ablate or "(full)"] = max(worst.get(ablate or "(full)", 0.0),
                                                (go - po).abs().max().item(),
                                                (gp - pp).abs().max().item())
                bitwise = None
                if not ablate:
                    kern.force_ablation_build = True
                    try:
                        ao, ap, am = kern(o, p_planes, sup, *args, **kw)
                    finally:
                        kern.force_ablation_build = False
                    bitwise = bool(torch.equal(ao, go) and torch.equal(ap, gp)
                                   and torch.equal(am, gm))
                # Z cut by rows (force_z_layout 2) where the plan keeps it whole.
                kern.force_z_layout = 2
                try:
                    co, cp, cm = kern(o, p_planes, sup, *args, **kw)
                    cut_plan = dict(kern.plan)
                finally:
                    kern.force_z_layout = 0
                cut_bitwise = bool(plan["zcut"] == 0 and cut_plan["zcut"] == 1
                                   and torch.equal(co, go) and torch.equal(cp, gp)
                                   and torch.equal(cm, gm))
                want = (2 - (ablate == "omax-const")) if key == "K2" else 21
                emit({"phase": "bench", "step": "ablate_vs_plain", "kernel": key,
                      "dft_precision": tier, "ablate": ablate or "(full)", "sweeps": 1,
                      "rel_err_o": rel_o, "rel_err_p": rel_p,
                      "metrics": [gm.tolist(), pm.tolist()], "limits": [tol_o, tol_p, tol_m],
                      "launches": launched, "plan": plan, "plan_z_cut": cut_plan,
                      "z_cut_bitwise_z_whole": cut_bitwise,
                      "ablation_build_bitwise_main": bitwise, "gpu": smi})
                check(rel_o <= tol_o and rel_p <= tol_p and m_ok,
                      f"{key} ablate={ablate!r} {tier} is off its plain version: "
                      f"{rel_o}, {rel_p}, metrics {gm.tolist()} vs {pm.tolist()}")
                check(launched == want, f"{key} ablate={ablate!r}: {launched} launches, not {want}")
                check(bitwise is not False,
                      f"{key}: ablate='' through the ablation build is not bitwise the kernel")
                check(cut_bitwise, f"{key} ablate={ablate!r} {tier}: Z cut by rows is not "
                      f"bitwise Z whole ({plan['zcut']} / {cut_plan['zcut']})")
        summary[key] = {"library": build.ablation_library(
                            "epry_chunked" if key == "K1" else "epry_sweep")._name.rsplit("/", 1)[-1],
                        "variants": list(names), "max_abs_err_by_variant": worst,
                        "empty_bitwise_main": True, "z_cut_bitwise_z_whole": True}
    checks_s = time.perf_counter() - t0

    # fpm_torch.bench through its entry point, in this process: one line.
    t1 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--seed", str(seed)])
    lines = out.getvalue().splitlines()
    check(rc == 0 and len(lines) == 1, f"fpm_torch.bench exited {rc} with {len(lines)} lines")
    line = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if k not in line]
    check(not missing, f"fpm_torch.bench's line lacks {missing}")
    check(line["amp_rmse_10"] < RMSE_LIMIT and line["device"] == smi
          and line["metric"] == "led_frames_per_s_per_gpu_per_iter"
          and all(math.isfinite(line[k]) and line[k] > 0 for k in (
              "value", "vs_baseline", "seconds_per_iteration", "device_ms_per_sweep",
              "busy_share", "bound_ms", "bound_share", "executed_tflops")),
          f"fpm_torch.bench's line is not well formed: {line}")
    emit({"phase": "bench", "step": "headline", "line": line,
          "secondary": json.loads(bench.SECONDARY_OUT.read_text()),
          "seconds": time.perf_counter() - t1})
    # The --ablate rows of both kernels, on a short ladder.
    t2 = time.perf_counter()
    cfg, geom, images, _ = bench.make_problem(seed)
    for chunked in (False, True):
        for row in bench.ablation_rows(cfg, geom, images, "cuda", chunked,
                                       ladder_=BENCH_ABLATE_LADDER):
            emit({"phase": "bench", "step": "ablate", "ladder": BENCH_ABLATE_LADDER, **row,
                  "gpu": smi})
    emit({"phase": "bench", "step": "seconds", "ablate_vs_plain_s": checks_s,
          "bench_s": t2 - t1, "ablate_rows_s": time.perf_counter() - t2})
    return summary


def surface_phase(cfg, geom, frames, smi: str) -> None:
    """12. The public solver functions of ``fpm_torch.models`` on the card
    (module docstring)."""
    import torch

    from fpm_torch.models import (EPRYOptions, init_state, reconstruct, sweep_batched_pallas,
                                  sweep_pallas)
    from fpm_torch.models.epry import _sorted_device_inputs, chunk_permute
    from fpm_torch.ops import kernels

    dev = torch.device("cuda")
    amps, starts = _sorted_device_inputs(frames, geom, torch.complex64, dev)
    o, p, sup = init_state(cfg, geom, amps)
    res = reconstruct(frames, geom, cfg, iterations=0, use_pallas=True)
    init_err = max(rel(o.cpu(), torch.from_numpy(res.obj_f_centered)),
                   rel(p.cpu(), torch.from_numpy(res.pupil)))
    on_card = o.is_cuda and p.is_cuda and sup.is_cuda and sup.dtype == torch.complex64
    emit({"phase": "surface", "function": "init_state", "rel_err_vs_reconstruct_init": init_err,
          "limit": 1e-6, "on_card": on_card, "gpu": smi})
    check(on_card and init_err <= 1e-6,
          f"init_state is {init_err} off reconstruct's init, or not on the card")
    planes = (torch.stack([o.real, o.imag]), torch.stack([p.real, p.imag]), sup.real)
    wrappers = {"K1": kernels.fused_epry_chunked, "K2": kernels.fused_epry_sweep}
    for tier in TIERS:
        for fn, key, mode in ((sweep_pallas, "K2", "sequential"),
                              (sweep_batched_pallas, "K1", "batched")):
            opts = EPRYOptions.from_config(cfg, use_pallas=True, mode=mode, chunk_size=32,
                                           dft_precision=tier)
            kw = dict(np_size=cfg.np_size, n_large=cfg.n_large, delta1=cfg.delta1,
                      delta2=cfg.delta2, eps=cfg.eps, pupil_radius=opts.pupil_radius,
                      collect_metrics=opts.collect_metrics, dft_precision=tier)
            for w in wrappers.values():
                w.launches = 0
            if key == "K2":
                got = fn(o, p, amps, starts, support=sup, opts=opts)
                counts = {k: w.launches for k, w in wrappers.items()}
                want = kernels.fused_epry_sweep(*planes, amps, starts.reshape(-1),
                                                global_max=opts.global_max, **kw)
            else:
                a, s_, m = chunk_permute(amps, starts, 32, "strided", torch.float32)
                got = fn(o, p, a, s_, m, support=sup, opts=opts)
                counts = {k: w.launches for k, w in wrappers.items()}
                want = kernels.fused_epry_chunked(*planes, a, s_.reshape(-1),
                                                  (m > 0).reshape(-1).to(torch.int32),
                                                  pupil_step_scale=opts.pupil_step_scale, **kw)
            torch.cuda.synchronize()
            same = bool(torch.equal(got[0], torch.complex(want[0][0], want[0][1]))
                        and torch.equal(got[1], torch.complex(want[1][0], want[1][1]))
                        and torch.equal(got[2], want[2]))
            emit({"phase": "surface", "function": fn.__name__, "dft_precision": tier,
                  "launches": counts, "bitwise_equal_to_wrapper": same, "gpu": smi})
            check(same, f"{fn.__name__} {tier} is not bitwise its kernel wrapper")
            check(counts[key] > 0 and all(c == 0 for k, c in counts.items() if k != key),
                  f"{fn.__name__} {tier}: launches {counts}")


BENCH_CELL_LADDER = (2, 12, 2)     # lo, hi sweeps, reps of phase 11's cells
BENCH_CELL_RUNS = 2
CELL_KERNEL = {"batched": ("K1", 21, "chunk_forward"), "sequential": ("K2", 2, "k2_sweep")}


def benchmark_phase(smi: str) -> None:
    """11. every cell of BENCHMARK.json once (module docstring)."""
    from fpm_torch import bench

    with open(bench.BENCHMARK) as f:
        metrics = json.load(f)["metrics"]
    for name, cell in bench.benchmark_cells().items():
        t0 = time.perf_counter()
        line, crumbs = bench.run_cell(name, bench.REPO / cell["config"], cell["traffic"],
                                      "cuda", ladder_=BENCH_CELL_LADDER, runs=BENCH_CELL_RUNS,
                                      control=True)
        named = list(metrics["end_to_end"]) + [
            m for m, spec in metrics["per_layer"].items() if name in spec["workloads"]]
        bad = [m for m in named if not (isinstance(line.get(m), (int, float))
                                        and math.isfinite(line[m]) and line[m] > 0)]
        key, per_sweep, kernel = CELL_KERNEL[cell["traffic"]["mode"]]
        emit({"phase": "benchmark", "cell": name, "ladder": BENCH_CELL_LADDER,
              "runs": BENCH_CELL_RUNS, "line": line, "breakdown": crumbs,
              "seconds": time.perf_counter() - t0, "gpu": smi})
        check(not bad, f"cell {name}: metrics missing or not finite and above 0: {bad}")
        check(line["correct"] is True, f"cell {name} is not correct: {line['checks']}")
        check(line["launches_per_sweep"] == per_sweep and line["launches"][key] > 0,
              f"cell {name}: launches {line['launches']}, not {per_sweep} of {key} a sweep")
        check(line["bound_share"] < 1 and line["device"] == smi,
              f"cell {name}: bound_share {line['bound_share']}, device {line['device']}")
        trace = line["device_trace"]
        check(trace["traced"] == trace["launched"] > 0,
              f"cell {name}: the traced run's trace holds {trace['traced']} of its kernels, "
              f"{trace['launched']} launched")
        check(line["control"]["correct"] is False,
              f"cell {name}: the one-pass control came out correct: {line['control']}")
        check(any(kernel in k["name"] for k in crumbs["top_kernels"]),
              f"cell {name}: {kernel} is not among the traced run's top kernels")


HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE_LIMIT = 1e-3               # tests/test_torch_solver.py: complex64 against the oracle
DEBUG_OBJECT_LIMIT = 1e-6
INTERMEDIATES_LIMIT = {"complex128": 1e-10, "complex64": 1e-4}
DEBUG_SWEEPS, DEBUG_LED, MESH_SWEEPS = 3, 3, 3
LEVERS = ["--comm-precision", "bf16", "--stale-consensus"]


def cli_recording(argv) -> dict:
    """``fpm_torch.cli.main(argv)`` with every launch counter at 0 before:
    its exit code and wall seconds, the launches of each kernel, and every
    mesh it built, described and with its counted collectives."""
    from fpm_torch import bench, cli
    from fpm_torch.parallel import mesh as mesh_mod

    meshes, init = [], mesh_mod.Mesh.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        meshes.append(self)

    wrappers = bench.wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(mesh_mod.Mesh, "__init__", record):
        rc = cli.main(argv)
    return {"rc": rc, "wall_s": time.perf_counter() - t0,
            "launches": {k: w.launches for k, w in wrappers.items()},
            "meshes": [m.describe() for m in meshes],
            "counts": [{",".join(key): v for key, v in m.counts.items()} for m in meshes]}


def cli_child(argv) -> int:
    """One process of a multi-process run: :func:`cli_recording`, printed."""
    rec = cli_recording(argv)
    print("CHILD " + json.dumps(rec), flush=True)
    return rec["rc"]


def processes(argv_of, n: int, timeout: float = 600) -> list[dict]:
    """``fpm_torch run`` as processes 0..n-1 of one run (``FPM_*`` set, a
    free port on localhost), each through :func:`cli_child`; every process
    is stopped before this returns. Returns their records."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for pid in range(n):
            env = dict(os.environ, FPM_COORDINATOR=f"127.0.0.1:{port}",
                       FPM_NUM_PROCESSES=str(n), FPM_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, chip_smoke; sys.exit(chip_smoke.cli_child(sys.argv[1:]))",
                 *argv_of(pid)], cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"process {pid} exited {p.returncode}: {err[-3000:]}")
        records.append(json.loads([ln for ln in out.splitlines()
                                   if ln.startswith("CHILD ")][-1][len("CHILD "):]))
    return records


def oracle_phase(cfg, geom, frames, smi) -> None:
    """K2 (sequential ``reconstruct``, kernel route) against the port's NumPy
    oracle on the card's machine, 3 sweeps, at both tiers."""
    import numpy as np

    from fpm_torch import bench
    from fpm_torch.models import epry
    from fpm_torch.oracle import run_fpm_oracle
    from fpm_torch.utils.metrics import complex_field_rmse

    t0 = time.perf_counter()
    ora = run_fpm_oracle(frames, geom, cfg, iterations=3)
    oracle_s = time.perf_counter() - t0
    for tier in TIERS:
        wrappers = bench.wrappers()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = epry.reconstruct(frames, geom, cfg, iterations=3, use_pallas=True,
                               dft_precision=tier)
        solve_s = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        rel_f = float(np.abs(res.obj_f - ora.obj_f).max() / np.abs(ora.obj_f).max())
        rmse = complex_field_rmse(res.obj_crop, ora.obj_crop)
        emit({"phase": "oracle", "dft_precision": tier, "sweeps": 3, "leds": geom.num_leds,
              "np": cfg.np_size, "obj_crop_complex_field_rmse": rmse,
              "obj_f_rel_max": rel_f, "limit_obj_f_rel_max": ORACLE_LIMIT if tier == "highest"
              else None, "launches": counts, "oracle_s_host": oracle_s,
              "reconstruct_s": solve_s, "gpu": smi})
        check(counts["K2"] == 6 and counts["K1"] == counts["K3"] == 0,
              f"oracle phase {tier}: launches {counts}, not K2 only, 2 per sweep")
        check(np.isfinite(rmse) and np.isfinite(rel_f), f"oracle phase {tier}: not finite")
        if tier == "highest":
            check(rel_f <= ORACLE_LIMIT,
                  f"K2 at highest lies {rel_f} from the oracle (limit {ORACLE_LIMIT})")


def debug_phase(cfg, geom, frames, smi, tmp) -> None:
    """``run --debug --debug-led 3 -n 3 --use-pallas`` in both modes on the
    card against the same command on the CPU (the files under ``debug/``)
    and without ``--debug`` on the card (``object.npy``); then
    ``led_intermediates`` on the card against the CPU from one state."""
    import numpy as np
    import torch

    from fpm_torch.models import epry

    mono = write_dataset(os.path.join(tmp, "debug_data"), cfg, geom, frames)
    for mode, key in (("sequential", "K2"), ("batched", "K1")):
        base = ["run", mono, "-n", str(DEBUG_SWEEPS), "--use-pallas", "--mode", mode]
        dbg = ["--debug", "--debug-led", str(DEBUG_LED)]
        dirs = {name: os.path.join(tmp, f"debug_{mode}_{name}")
                for name in ("card", "cpu", "no_debug")}
        recs = {"card": cli_recording([*base, "-o", dirs["card"], *dbg]),
                "cpu": cli_recording([*base, "-o", dirs["cpu"], *dbg, "--platform", "cpu"]),
                "no_debug": cli_recording([*base, "-o", dirs["no_debug"]])}
        for name, rec in recs.items():
            check(rec["rc"] == 0, f"debug {mode} {name} exited {rec['rc']}")
        for name in ("card", "no_debug"):
            launched = recs[name]["launches"]
            check(launched[key] > 0 and all(c == 0 for k, c in launched.items() if k != key),
                  f"debug {mode} {name}: launches {launched}, not {key} only")
        check(all(c == 0 for c in recs["cpu"]["launches"].values()),
              f"debug {mode} on the CPU launched kernels: {recs['cpu']['launches']}")
        files = {name: sorted(os.listdir(os.path.join(dirs[name], "debug")))
                 for name in ("card", "cpu")}
        objs = {name: np.load(os.path.join(dirs[name], "object.npy"))
                for name in ("card", "no_debug")}
        rel_obj = float(np.abs(objs["card"] - objs["no_debug"]).max()
                        / np.abs(objs["no_debug"]).max())
        emit({"phase": "debug", "mode": mode, "kernel": key, "sweeps": DEBUG_SWEEPS,
              "debug_led": DEBUG_LED, "debug_files": len(files["card"]),
              "debug_files_equal_cpu": files["card"] == files["cpu"],
              "object_rel_max_vs_no_debug": rel_obj,
              "object_bitwise_no_debug": bool(np.array_equal(objs["card"], objs["no_debug"])),
              "limit": DEBUG_OBJECT_LIMIT,
              "wall_s": {name: rec["wall_s"] for name, rec in recs.items()},
              "launches": {name: rec["launches"] for name, rec in recs.items()}, "gpu": smi})
        check(files["card"] == files["cpu"],
              f"debug {mode}: files on the card {files['card']} != on the CPU {files['cpu']}")
        want = 2 * DEBUG_SWEEPS + 6 * DEBUG_SWEEPS
        check(len([f for f in files["card"] if f.startswith("iter")]) == want,
              f"debug {mode}: {len(files['card'])} files, want {want} iteration images")
        check(rel_obj <= DEBUG_OBJECT_LIMIT,
              f"debug {mode}: object {rel_obj} from the run without --debug")

    state = epry.reconstruct(frames, geom, cfg, iterations=1, use_pallas=True)
    state = (state.obj_f_centered, state.pupil)
    errs = {}
    for dtype, limit in INTERMEDIATES_LIMIT.items():
        for k in (DEBUG_LED, geom.num_leds - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = epry.led_intermediates(state, frames, geom, cfg, k, dtype=dtype,
                                          device="cuda")
            card_s = time.perf_counter() - t0
            host = epry.led_intermediates(state, frames, geom, cfg, k, dtype=dtype,
                                          device="cpu")
            rel = {name: float(np.abs(card[name] - host[name]).max() / np.abs(host[name]).max())
                   for name in host}
            errs[f"{dtype} led {k}"] = {"rel_max": rel, "card_s": card_s}
            check(max(rel.values()) <= limit,
                  f"led_intermediates {dtype} at {k}: card against CPU {rel} (limit {limit})")
    emit({"phase": "debug", "step": "led_intermediates card vs cpu",
          "limits": INTERMEDIATES_LIMIT, "cases": errs, "gpu": smi})


def comm_mismatches(counts: dict, nl: int, n: int, k: int, led: int, tile: int,
                    bf16: bool) -> list[str]:
    """A mesh run's counted collectives (``"op,axis"`` keys) against the
    analytic model of ``parallel.comm`` after ``MESH_SWEEPS`` sweeps at chunk
    32. With the bf16 wire only the reverse halo travels in bf16 (as in
    fpm_tpu); the model at 4 bytes halves the forward halo too, so the
    halo line is held to forward at 8 bytes plus reverse at 4."""
    from fpm_torch.parallel import comm

    counts = {tuple(key.split(",", 1)): v for key, v in counts.items()}
    size = 4 if bf16 else 8
    if tile == 1:
        model = comm.led_shard_comm(nl, n, k, 32, led, size)
        return comm.counted_mismatches(counts, model, sweeps=MESH_SWEEPS)
    model = comm.tile_shard_comm(nl, n, k, led, tile, 32, size)
    hops = -(-n // (nl // tile))
    diffs = comm.counted_mismatches(counts, model, sweeps=MESH_SWEEPS, halo_hops=hops)
    if bf16:
        halo = model["collectives"][0]["payload_bytes"] * model["n_chunks_per_sweep"]
        want = {"calls": 2 * hops * model["n_chunks_per_sweep"] * MESH_SWEEPS,
                "payload_bytes": 3 * halo * MESH_SWEEPS}
        diffs = [d for d in diffs if not d.startswith("ppermute over tile")]
        if counts.get(("ppermute", "tile")) != want:
            diffs.append(f"ppermute over tile: {counts.get(('ppermute', 'tile'))}, want {want}")
    return diffs


def distributed_phase(cfg, geom, frames, wide_frames, smi, tmp) -> None:
    """Two processes on the one card over gloo against one process:
    ``--mesh 2 1`` and ``--mesh 1 2`` (each once with the bf16 wire and the
    stale consensus) and ``--fov-grid 8 8``; then one process over nccl."""
    import numpy as np

    mono = write_dataset(os.path.join(tmp, "dist_data"), cfg, geom, frames)
    wide = write_dataset(os.path.join(tmp, "dist_wide"), cfg, geom, wide_frames)
    n, nl, k = cfg.np_size, cfg.n_large, geom.num_leds

    def compare(label, flags, n_proc, arrays, transport, key):
        one_dir = os.path.join(tmp, f"one_{label}")
        dirs = [os.path.join(tmp, f"p{pid}_{label}") for pid in range(n_proc)]
        one = cli_recording(["run", *flags, "-o", one_dir])
        check(one["rc"] == 0, f"{label}: one process exited {one['rc']}")
        t0 = time.perf_counter()
        recs = processes(lambda pid: ["run", *flags, "-o", dirs[pid], "--distributed"], n_proc)
        launched_s = time.perf_counter() - t0
        bitwise = {a: bool(np.array_equal(np.load(os.path.join(dirs[0], a)),
                                          np.load(os.path.join(one_dir, a)))) for a in arrays}
        others = {pid: sorted(os.listdir(dirs[pid])) for pid in range(1, n_proc)}
        line = {"phase": "distributed", "run": label, "processes": n_proc,
                "flags": flags[1:], "bitwise_one_process": bitwise,
                "other_process_files": others,
                "wall_s": {"processes": [r["wall_s"] for r in recs], "one": one["wall_s"],
                           "processes_start_to_exit": launched_s},
                "launches": {"processes": [r["launches"] for r in recs],
                             "one": one["launches"]},
                "mesh": recs[0]["meshes"], "gpu": smi}
        for pid, rec in enumerate(recs):
            check(rec["launches"][key] > 0 and all(
                c == 0 for kk, c in rec["launches"].items() if kk != key),
                f"{label}: process {pid} launched {rec['launches']}, not {key} only")
        check(all(bitwise.values()), f"{label}: not bitwise the one-process run: {bitwise}")
        check(all(not files for files in others.values()),
              f"{label}: a process other than 0 wrote {others}")
        if transport:
            check(all(f"transport {transport}" in m for r in recs for m in r["meshes"]),
                  f"{label}: transport is not {transport}: {recs[0]['meshes']}")
        return line, one, recs

    for led, tile in ((2, 1), (1, 2)):
        for levers in (False, True):
            label = f"mesh {led} {tile}" + (" bf16 stale" if levers else "")
            flags = [mono, "-n", str(MESH_SWEEPS), "--use-pallas", "--mesh", str(led),
                     str(tile), *(LEVERS if levers else [])]
            line, one, recs = compare(label.replace(" ", "_"), flags, 2,
                                      ("object_spectrum.npy", "pupil.npy"), "gloo", "K3")
            diffs = {pid: comm_mismatches(r["counts"][0], nl, n, k, led, tile, levers)
                     for pid, r in enumerate(recs)}
            same = all(r["counts"] == one["counts"] for r in recs)
            emit({**line, "counted_collectives": recs[0]["counts"][0],
                  "counts_equal_one_process": same, "counted_vs_model": diffs})
            check(same, f"{label}: counted collectives differ from the one-process mesh")
            check(not any(diffs.values()), f"{label}: counted collectives vs model {diffs}")

    flags = [wide, "-n", "10", "--use-pallas", "--fov-grid", "8", "8"]
    line, _, recs = compare("fov_grid_8_8", flags, 2, ("object_stitched.npy",), None, "K2")
    emit(line)

    flags = [mono, "-n", str(MESH_SWEEPS), "--use-pallas", "--mesh", "1", "1"]
    line, _, _ = compare("mesh_1_1_nccl", flags, 1, ("object_spectrum.npy", "pupil.npy"),
                         "nccl", "K3")
    emit(line)



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
    from fpm_torch.bench import (amplitude_rmse, bound, increments_work, sweep_work,
                                 window_union)
    from fpm_torch.config import FPMConfig, load_config
    from fpm_torch.data.loader import load_dataset_rgb
    from fpm_torch.data.simulate import make_test_object, simulate_images
    from fpm_torch.geometry import compute_geometry, pupil_support
    from fpm_torch.models import epry
    from fpm_torch.models.largefov import reconstruct_large_fov, stitch_fields
    from fpm_torch.parallel.roi_shard import reconstruct_large_fov_sharded
    from fpm_torch.ops import build, kernels
    from fpm_torch.parallel import comm, led_shard, make_mesh, tile_shard

    # ------------------------------------------------------------ 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs, ablation_libs = build.build_with_ablations()
    build_s = time.perf_counter() - t0
    # Tensor-core instructions per function of each library's SASS: every
    # bf16x3 instantiation holds its products (inlined), no highest one any.
    hmma = {stem: {short_name(k): v for k, v in build.hmma_counts(stem).items()}
            for stem in sorted(libs)}
    emit({"phase": "device", "gpu": smi, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "kernel_build_s": build_s,
          "libraries": sorted(p.name for p in libs.values()),
          "ablation_libraries": sorted(p.name for p in ablation_libs.values()),
          "hmma_instructions": hmma,
          "ptxas": {stem: {short_name(k): v for k, v in build.resources(stem).items()}
                    for stem in sorted(libs)},
          "ptxas_ablation": {stem: {short_name(k): v for k, v in
                                    build.resources(stem, ablate=True).items()}
                             for stem in sorted(ablation_libs)}})
    for stem, counts in hmma.items():
        by_tier = {}
        for name, c in counts.items():
            tier_id = instantiation_tier(name)
            if tier_id is not None:
                by_tier.setdefault(tier_id, []).append(c)
        check(by_tier.get(1) and all(c > 0 for c in by_tier[1]),
              f"{stem}: a bf16x3 instantiation holds no HMMA instruction: {counts}")
        check(by_tier.get(0) and all(c == 0 for c in by_tier[0]),
              f"{stem}: a highest instantiation holds HMMA instructions: {counts}")

    dev = torch.device("cuda")
    digests = kernel_digests(dev)
    digests["sharded"] = sharded_digests(args.seed)
    emit(digests)
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

    # Whole camera frames: the mono dome optics at np_size=568 (NL=2272),
    # the same 193 LEDs; their Np=90 ROIs are the problems of the
    # problem-axis checks and the tiles of the large-FOV run.
    t0 = time.perf_counter()
    cfg_wide = FPMConfig(max_illumination_na=0.45, np_size=WIDE, iterations=10)
    geom_wide = compute_geometry(cfg_wide)
    check(np.array_equal(geom_wide.led_numbers, geom.led_numbers),
          "the 568-px frames light other LEDs than the Np=90 problem")
    obj_wide = make_test_object(cfg_wide.n_large, seed=args.seed)
    wide_frames = simulate_images(obj_wide, geom_wide, cfg_wide, quantize=True)
    wide_sim_s = time.perf_counter() - t0
    origins = [(y, x) for y in range(0, WIDE - n + 1, ROI_STEP)
               for x in range(0, WIDE - n + 1, ROI_STEP)][:max(AXIS_P)]
    amps_p = torch.stack([
        epry._sorted_device_inputs(wide_frames[:, y:y + n, x:x + n], geom, torch.complex64,
                                   dev)[0] for y, x in origins])
    inits = [epry.init_traced(a, sup_r, opts) for a in amps_p]
    o_p = torch.stack([torch.stack([o.real, o.imag]) for o, _ in inits]).contiguous()
    p_p = torch.stack([torch.stack([p.real, p.imag]) for _, p in inits]).contiguous()
    del inits
    amps_it_p = torch.stack([epry._chunk_inputs(a, starts, opts_b, torch.float32)[0]
                             for a in amps_p])
    axis_cases = {   # name: (wrapper, plain version, the (P, ...) frames, shared operands, options)
        "K1": (kernels.fused_epry_chunked, kernels.fused_epry_chunked_plain, amps_it_p,
               (starts_it.reshape(-1), valid), dict(pupil_step_scale=1.0)),
        "K2 exact": (kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain, amps_p,
                     (starts.reshape(-1),), dict(global_max="exact")),
        "K2 lazy": (kernels.fused_epry_sweep, kernels.fused_epry_sweep_plain, amps_p,
                    (starts.reshape(-1),), dict(global_max="lazy")),
    }
    emit({"phase": "setup", "wide_frames": list(wide_frames.shape), "wide_sim_s": wide_sim_s,
          "problem_axis_problems": len(origins), "roi_step": ROI_STEP})

    # --------------------------------------------------- 2. kernel_vs_plain
    # Each kernel at each tier, at the cluster size its entry point chooses
    # (forced = 0) and at forced sizes 1 (one block per LED) and 2 (the
    # smallest cluster whose blocks read each other's shared memory), against
    # one run of the plain version at the same tier; then the chosen size once
    # more from the same state: bitwise equal. errs and chosen_cs are keyed by
    # (case, tier).
    outside = torch.as_tensor(pupil_support(cfg), device=dev) == 0
    errs, chosen_cs = {}, {}

    def sweeps(fn, rest, extra):
        state, mets = (o_planes, p_planes), []
        for _ in range(2):
            o, p, m = fn(*state, sup_r, *rest, **common, **extra)
            state = (o, p)
            mets.append(m.tolist())
        torch.cuda.synchronize()
        return state, np.array(mets)

    for tier in TIERS:
        for name, (kern, plain, rest, extra) in cases.items():
            extra = dict(extra, dft_precision=tier)
            (op_, pp_), mp = sweeps(plain, rest, extra)
            for forced in (0, 1, 2):
                kern.force_cluster_size = forced
                (ok_, pk), mk = sweeps(kern, rest, extra)
                kern.force_cluster_size = 0
                rel_o, rel_p = rel(ok_, op_), rel(pk, pp_)
                max_abs = max((ok_ - op_).abs().max().item(), (pk - pp_).abs().max().item())
                rel_m = float(np.max(np.abs(mk - mp) / np.abs(mp)))
                leak = pk[:, outside].abs().max().item()
                errs[name, tier] = max(errs.get((name, tier), 0.0), max_abs)
                if not forced:
                    chosen_cs[name, tier] = kern.cluster_size
                    first = (ok_, pk, mk)
                emit({"phase": "kernel_vs_plain", "case": name, "dft_precision": tier,
                      "forced_cluster_size": forced, "cluster_size": kern.cluster_size,
                      "sweeps": 2, "rel_err_o": rel_o, "rel_err_p": rel_p,
                      "max_abs_err": max_abs, "metrics_rel_err": rel_m,
                      "pupil_outside_support": leak,
                      "limits": {"rel_o": TOL_O, "rel_p": TOL_P, "metrics_rtol": TOL_METRICS}})
                check(kern.cluster_size == (forced or chosen_cs[name, tier]),
                      f"{name} {tier} ran at cluster size {kern.cluster_size}, forced {forced}")
                check(rel_o <= TOL_O and rel_p <= TOL_P and rel_m <= TOL_METRICS
                      and leak == 0.0,
                      f"{name} {tier} (forced cluster size {forced}) disagrees with its plain "
                      "version")
            (ok_, pk), mk = sweeps(kern, rest, extra)
            same = (torch.equal(ok_, first[0]) and torch.equal(pk, first[1])
                    and np.array_equal(mk, first[2]))
            emit({"phase": "kernel_vs_plain", "case": name + ", repeated", "dft_precision": tier,
                  "cluster_size": kern.cluster_size, "sweeps": 2, "bitwise_equal": same})
            check(same, f"{name} {tier}: two runs from the same state differ")
        check(chosen_cs["K1", tier] > 1 and chosen_cs["K2 exact", tier] > 1,
              f"one LED does not run on a cluster of several blocks: {chosen_cs}")

    # The three passes of bf16x3 all run: K2 at bf16x3 is within the tier's
    # limits of K2 at highest, where a plain sweep whose products keep only
    # hi·hi is far off.
    k2_kern, k2_plain, k2_rest, k2_extra = cases["K2 exact"]
    (bo, bp), _ = sweeps(k2_kern, k2_rest, dict(k2_extra, dft_precision="bf16x3"))
    (ho, hp), _ = sweeps(k2_kern, k2_rest, dict(k2_extra, dft_precision="highest"))
    with mock.patch.object(kernels, "cmm_bf16x3", kernels.cmm_hi_hi):
        (oo, op1), _ = sweeps(k2_plain, k2_rest, dict(k2_extra, dft_precision="bf16x3"))
    tier_err = {"rel_err_o": rel(bo, ho), "rel_err_p": rel(bp, hp)}
    one_pass_err = {"rel_err_o": rel(oo, ho), "rel_err_p": rel(op1, hp)}
    emit({"phase": "kernel_vs_plain", "case": "K2 bf16x3 against K2 highest", "sweeps": 2,
          "bf16x3_kernel": tier_err, "one_pass_plain": one_pass_err,
          "limits": {"rel_o": TOL_TIER_O, "rel_p": TOL_TIER_P, "one_pass_min": ONE_PASS_MIN}})
    check(tier_err["rel_err_o"] <= TOL_TIER_O and tier_err["rel_err_p"] <= TOL_TIER_P,
          f"K2 at bf16x3 is not within the tier's limits of highest: {tier_err}")
    check(max(one_pass_err.values()) > ONE_PASS_MIN,
          f"one hi·hi pass is as close to highest as three: {one_pass_err}")
    del bo, bp, ho, hp, oo, op1

    # K3: one call per case. (d, v, mets) against the plain version; d exactly
    # 0 outside the valid windows; v exactly 0 outside the support.
    o1_planes, p1_planes, _ = kernels.fused_epry_chunked(
        o_planes, p_planes, sup_r, amps_it, starts_it.reshape(-1), valid, **common,
        pupil_step_scale=1.0)
    k3_common = {k: v for k, v in common.items() if k != "n_large"}
    # The full block with a whole chunk and with the 8 slots rank (0,0) of mesh
    # (4,1) gets; the halo-extended blocks of tile=2 with each tile's whole
    # workset (led=1) and with the share a rank of mesh (2,2) gets (led=2).
    k3_cases = {
        "K3 full block": (o_planes, p_planes, amps_it[0], starts_it[0].reshape(-1),
                          valid[:32].contiguous()),
        "K3 full block, rank of mesh (4,1)": (
            o_planes, p_planes, amps_it[0, :8].contiguous(),
            starts_it[0, :8].reshape(-1).contiguous(), valid[:8].contiguous()),
    }
    ring = torch.cat([o1_planes, o1_planes[:, :n]], dim=1)      # the halo wraps the ring
    for n_led, ti in ((1, 0), (1, 1), (2, 0), (2, 1)):
        idx, tile_s = tile_shard.partition_leds_by_tile(geom, nl, 2, n_led, n, chunk_size=32)
        sel = torch.as_tensor(idx[0, 0, ti], device=dev)
        live = sel >= 0
        check(int(live.sum()) > 1 and (n_led > 1 or not bool(live.all())),
              f"tile {ti}'s workset has too few LEDs, or no masked slot to check")
        starts_rel = (starts[sel.clamp(min=0)] - torch.tensor(
            [ti * tile_s, 0], dtype=torch.int32, device=dev)) * live[:, None]
        name = f"K3 tile block {ti}" + (", rank of mesh (2,2)" if n_led == 2 else "")
        k3_cases[name] = (
            ring[:, ti * tile_s:(ti + 1) * tile_s + n].contiguous(), p1_planes,
            amps[sel.clamp(min=0)] * live[:, None, None],
            starts_rel.to(torch.int32).reshape(-1).contiguous(), live.to(torch.int32))
    k3 = kernels.fused_chunk_increments
    for tier in TIERS:
        for name, (blk, pp, a_, st_, va_) in k3_cases.items():
            kw = dict(k3_common, n_rows=blk.shape[1], n_cols=blk.shape[2], dft_precision=tier)
            pd, pv, pm = kernels.fused_chunk_increments_plain(blk, pp, sup_r, a_, st_, va_,
                                                              **kw)
            tier_d = 0.0      # the tier's distance from FP32 on this call's d
            hd = None
            if tier != "highest":
                hd = kernels.fused_chunk_increments_plain(
                    blk, pp, sup_r, a_, st_, va_, **dict(kw, dft_precision="highest"))[0]
                tier_d = rel(pd, hd)
            # The same plain version on the CPU (another f32 summation order):
            # how far two orders of one function lie apart on d.
            cpu_d = kernels.fused_chunk_increments_plain(
                *(t.cpu() for t in (blk, pp, sup_r, a_, st_, va_)), **kw)[0]
            tol_d = max(TOL_O, tier_d)
            covered = torch.zeros(blk.shape[1:], dtype=torch.bool, device=dev)
            for (y, x), ok in zip(st_.view(-1, 2).tolist(), va_.tolist()):
                if ok:
                    covered[y + lo:y + lo + b, x + lo:x + lo + b] = True
            for forced in (0, 1, 2):
                k3.force_cluster_size = forced
                kd, kv, km = k3(blk, pp, sup_r, a_, st_, va_, **kw)
                k3.force_cluster_size = 0
                torch.cuda.synchronize()
                rel_d, rel_v = rel(kd, pd), rel(kv, pv)
                max_abs = max((kd - pd).abs().max().item(), (kv - pv).abs().max().item())
                rel_m = ((km - pm).abs() / pm.abs()).max().item()
                d_leak = kd[:, ~covered].abs().max().item()
                v_leak = kv[:, outside].abs().max().item()
                errs[name, tier] = max(errs.get((name, tier), 0.0), max_abs)
                if not forced:
                    chosen_cs[name, tier] = k3.cluster_size
                emit({"phase": "kernel_vs_plain", "case": name, "dft_precision": tier,
                      "forced_cluster_size": forced, "cluster_size": k3.cluster_size,
                      "block": list(blk.shape[1:]), "slots": int(va_.numel()),
                      "valid": int(va_.sum()), "rel_err_d": rel_d, "rel_err_v": rel_v,
                      "max_abs_err": max_abs, "metrics_rel_err": rel_m,
                      "d_outside_windows": d_leak, "v_outside_support": v_leak,
                      "plain_d_vs_plain_highest": tier_d,
                      "plain_d_cpu_vs_card": rel(cpu_d, pd.cpu()),
                      "kernel_d_vs_plain_cpu": rel(kd.cpu(), cpu_d),
                      "kernel_d_vs_plain_highest": rel(kd, hd) if hd is not None else 0.0,
                      "limits": {"rel_d": tol_d, "rel_v": TOL_P, "metrics_rtol": TOL_METRICS}})
                check(k3.cluster_size == (forced or chosen_cs[name, tier]),
                      f"{name} {tier} ran at cluster size {k3.cluster_size}, forced {forced}")
                check(rel_d <= tol_d and rel_v <= TOL_P and rel_m <= TOL_METRICS
                      and d_leak == 0.0 and v_leak == 0.0 and kd.abs().max().item() > 0,
                      f"{name} {tier} (forced cluster size {forced}) disagrees with its plain "
                      "version")
        check(chosen_cs["K3 full block, rank of mesh (4,1)", tier] > 1,
              f"K3 at 8 slots does not run one LED on several blocks: {chosen_cs}")

    # The problem axis: P problems in one launch against each problem's solo
    # launch (bitwise), problems 0 and P-1 against the plain version, and
    # with problem 1's frames NaN the others still bitwise their solo launch.
    def two_sweeps(fn, o, p, frames, shared, extra):
        mets = []
        for _ in range(2):
            o, p, m = fn(o, p, sup_r, frames, *shared, **common, **extra)
            mets.append(m)
        return o, p, torch.stack(mets)

    def same(got, want) -> bool:
        return all(torch.equal(a, b) for a, b in zip(got, want))

    for tier in TIERS:
        for name, (kern, plain, frames_p, shared, extra) in axis_cases.items():
            extra = dict(extra, dft_precision=tier)
            solo = [two_sweeps(kern, o_p[q], p_p[q], frames_p[q], shared, extra)
                    for q in range(max(AXIS_P))]
            solo_cs = kern.cluster_size
            plain_of = {}
            for n_prob in AXIS_P:
                kern.launches = 0
                o, p, m = two_sweeps(kern, o_p[:n_prob], p_p[:n_prob], frames_p[:n_prob], shared,
                                     extra)
                torch.cuda.synchronize()
                launched, cs = kern.launches, kern.cluster_size
                bitwise = [same((o[q], p[q], m[:, q]), solo[q]) for q in range(n_prob)]
                vs_plain = {}
                for q in (0, n_prob - 1):
                    if q not in plain_of:
                        plain_of[q] = two_sweeps(plain, o_p[q], p_p[q], frames_p[q], shared,
                                                 extra)
                    po, pp, pm = plain_of[q]
                    vs_plain[q] = {"rel_err_o": rel(o[q], po), "rel_err_p": rel(p[q], pp),
                                   "metrics_rel_err": ((m[:, q] - pm).abs() / pm.abs()).max().item(),
                                   "max_abs_err": max((o[q] - po).abs().max().item(),
                                                      (p[q] - pp).abs().max().item())}
                    errs[name, tier] = max(errs[name, tier], vs_plain[q]["max_abs_err"])
                poisoned = frames_p[:n_prob].clone()
                poisoned[1] = float("nan")
                no, np_, nm = two_sweeps(kern, o_p[:n_prob], p_p[:n_prob], poisoned, shared,
                                         extra)
                torch.cuda.synchronize()
                del poisoned
                isolated = [same((no[q], np_[q], nm[:, q]), solo[q])
                            for q in range(n_prob) if q != 1]
                per_sweep = 2 if name.startswith("K2") else 3 * amps_it.shape[0]
                emit({"phase": "kernel_vs_plain", "case": f"{name}, problem axis",
                      "dft_precision": tier, "problems": n_prob, "cluster_size": cs,
                      "solo_cluster_size": solo_cs, "sweeps": 2, "launches": launched,
                      "bitwise_equal_to_solo": sum(bitwise),
                      "vs_plain": {str(q): v for q, v in vs_plain.items()},
                      "nan_problem_1_finite": bool(torch.isfinite(no[1]).all().item()),
                      "others_bitwise_with_problem_1_nan": sum(isolated),
                      "limits": {"rel_o": TOL_O, "rel_p": TOL_P, "metrics_rtol": TOL_METRICS}})
                check(all(bitwise), f"{name} {tier}: {n_prob - sum(bitwise)} of {n_prob} "
                                    "problems differ from their solo launch")
                check(all(isolated) and not torch.isfinite(no[1]).all(),
                      f"{name} {tier}: a NaN problem changed another problem of the launch")
                check(launched == 2 * per_sweep,
                      f"{name} {tier}: {launched} launches for 2 sweeps of {n_prob} problems")
                check(all(v["rel_err_o"] <= TOL_O and v["rel_err_p"] <= TOL_P
                          and v["metrics_rel_err"] <= TOL_METRICS for v in vs_plain.values()),
                      f"{name} {tier} with {n_prob} problems disagrees with its plain version")
            del solo, plain_of

    # ------------------------------------------------- 3. sharded_vs_single
    mesh_shapes = ((4, 1), (2, 2), (1, 8))
    sharded_kw = dict(iterations=2, use_pallas=True, chunk_size=32)
    single = epry.reconstruct(frames, geom, cfg, mode="batched", **sharded_kw)

    def sharded_fn(tile):
        return (led_shard.reconstruct_led_sharded if tile == 1
                else tile_shard.reconstruct_tile_sharded)

    for led, tile in mesh_shapes:
        mesh = make_mesh(led=led, tile=tile)
        got = sharded_fn(tile)(frames, geom, cfg, mesh=mesh, **sharded_kw)
        rel_o = float(np.abs(got.obj_f_centered - single.obj_f_centered).max()
                      / np.abs(single.obj_f_centered).max())
        rel_p = float(np.abs(got.pupil - single.pupil).max() / np.abs(single.pupil).max())
        rel_m = max(float(np.max(np.abs(got.metrics[key] - single.metrics[key])
                                 / np.abs(single.metrics[key])))
                    for key in ("data_residual", "update_norm"))
        if tile == 1:
            model = comm.led_shard_comm(nl, n, k_leds, 32, led)
        else:
            model = comm.tile_shard_comm(nl, n, k_leds, led, tile, 32)
        hops = 1 if tile == 1 else -(-n // (nl // tile))
        diffs = comm.counted_mismatches(mesh.counts, model, sweeps=2, halo_hops=hops)
        emit({"phase": "sharded_vs_single", "mesh": [led, tile], "ranks": mesh.describe(),
              "sweeps": 2, "rel_err_o": rel_o, "rel_err_p": rel_p, "metrics_rel_err": rel_m,
              "limits": {"rel_o": TOL_O, "rel_p": TOL_P, "metrics_rtol": TOL_METRICS},
              "halo_hops": hops,
              "counted_collectives": {f"{op} over {ax}": v for (op, ax), v in mesh.counts.items()},
              "model_collectives_per_sweep": [
                  {k: c[k] for k in ("op", "axis", "payload_bytes", "calls_per_sweep")}
                  for c in model["collectives"]],
              "counted_vs_model": diffs})
        check(rel_o <= TOL_O and rel_p <= TOL_P and rel_m <= TOL_METRICS,
              f"mesh {(led, tile)} disagrees with the single-device K1 sweeps")
        check(not diffs, f"mesh {(led, tile)}: counted collectives differ from the model: {diffs}")

    # --------------------------------------------------------- 4. main_path
    launches = {}
    with tempfile.TemporaryDirectory(prefix="fpm_chip_smoke_") as tmp:
        cfg_path = write_dataset(os.path.join(tmp, "data"), cfg, geom, frames)
        decoder = ingest_both(load_config(cfg_path), f"{n}x{n} crops")[1]
        wrappers = {"K1": kernels.fused_epry_chunked, "K2": kernels.fused_epry_sweep,
                    "K3": kernels.fused_chunk_increments}
        # (label, flags, kernel, the same solve in this process); the default
        # tier (bf16x3) first, then the batched, sequential and (4,1) runs at
        # --dft-precision highest.
        runs = [
            ("batched", ["--mode", "batched"], "K1",
             lambda tier: epry.reconstruct(frames, geom, cfg, iterations=10, use_pallas=True,
                                           mode="batched", chunk_size=32, dft_precision=tier)),
            ("sequential", ["--mode", "sequential"], "K2",
             lambda tier: epry.reconstruct(frames, geom, cfg, iterations=10, use_pallas=True,
                                           mode="sequential", dft_precision=tier)),
            ("mesh 4 1", ["--mesh", "4", "1"], "K3",
             lambda tier: sharded_fn(1)(frames, geom, cfg, mesh=make_mesh(4, 1), iterations=10,
                                        use_pallas=True, chunk_size=32, dft_precision=tier)),
            ("mesh 2 2", ["--mesh", "2", "2"], "K3",
             lambda tier: sharded_fn(2)(frames, geom, cfg, mesh=make_mesh(2, 2), iterations=10,
                                        use_pallas=True, chunk_size=32, dft_precision=tier)),
        ]
        runs += [(label + " highest", flags + ["--dft-precision", "highest"], key, again)
                 for label, flags, key, again in runs[:3]]
        for label, flags, key, again in runs:
            tier = "highest" if label.endswith("highest") else "bf16x3"
            out = os.path.join(tmp, "out_" + label.replace(" ", "_"))
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["run", cfg_path, "-n", "10", "-o", out, "--use-pallas",
                           "--chunk-size", "32", *flags])
            wall = time.perf_counter() - t0
            counts = {k: w.launches for k, w in wrappers.items()}
            launches[label] = counts[key]
            check(rc == 0, f"fpm_torch run {label} exited {rc}")
            check(counts[key] > 0, f"run {label} launched no {key} kernel")
            check(all(c == 0 for k, c in counts.items() if k != key),
                  f"run {label} launched other kernels than {key}: {counts}")
            missing = [f for f in OUTPUT_FILES if not os.path.exists(os.path.join(out, f))]
            check(not missing, f"run {label} wrote no {missing}")
            obj = np.load(os.path.join(out, "object.npy"))
            check(obj.shape == (nl, nl) and np.isfinite(obj).all(),
                  f"run {label}: object {obj.shape} not finite of shape {(nl, nl)}")
            rmse = amplitude_rmse(obj, obj_true)
            with open(os.path.join(out, "manifest.json")) as f:
                resid = json.load(f)["metrics"]["data_residual"]
            with open(os.path.join(out, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            phase_s = {r["name"]: r["seconds"] for r in records if r["event"] == "phase"}
            options = next(r for r in records if r["event"] == "solver_options")
            run_decoder = next(r for r in records if r["event"] == "dataset")["decoder"]
            check(run_decoder == decoder, f"run {label} decoded with {run_decoder}, not {decoder}")
            want_mesh = [int(x) for x in flags[1:3]] if flags[0] == "--mesh" else None
            check(options["mesh"] == want_mesh and (want_mesh is None
                                                    or options["mode"] == "batched"),
                  f"run {label} recorded mesh {options['mesh']}, mode {options['mode']}")
            check(options["dft_precision"] == tier,
                  f"run {label} recorded dft_precision {options['dft_precision']}")
            # The same solve again in this process, warm (cuFFT plans and
            # libraries loaded): what a second reconstruction pays.
            warm_s = []
            for _ in range(2):
                t0 = time.perf_counter()
                again(tier)
                torch.cuda.synchronize()
                warm_s.append(time.perf_counter() - t0)
            emit({"phase": "main_path", "run": label, "dft_precision": tier,
                  "iterations": 10, "wall_s": wall,
                  "phase_s": phase_s, "reconstruct_warm_s": warm_s[-1],
                  "launches": counts, "recorded_mesh": options["mesh"],
                  "decoder": run_decoder, "amp_rmse": rmse, "rmse_limit": RMSE_LIMIT,
                  "data_residual_first_last": [resid[0], resid[-1]]})
            check(rmse < RMSE_LIMIT, f"run {label} amplitude RMSE {rmse} >= {RMSE_LIMIT}")

    # --------------------------------------------------- 4b. large_fov, rgb
    per_sweep_launches = {"K1": 3 * amps_it.shape[0], "K2": 2}
    mode_kernel = {"sequential": "K2", "batched": "K1"}
    path_launches = {}

    def run_cli(flags):
        """``fpm_torch run`` through cli.main with every counter at 0 before;
        returns (wall s, the counters after)."""
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["run", *flags])
        wall = time.perf_counter() - t0
        check(rc == 0, f"fpm_torch run {flags} exited {rc}")
        return wall, {k: w.launches for k, w in wrappers.items()}

    def tile_planes(path):
        with np.load(path) as z:
            return {k: z[k] for k in ("obj_crop_p", "obj_f_p", "pupil_p", "metrics")}

    def result_planes(res):
        return {"obj_crop_p": np.stack([res.obj_crop.real, res.obj_crop.imag]),
                "obj_f_p": np.stack([res.obj_f_centered.real, res.obj_f_centered.imag]),
                "pupil_p": np.stack([res.pupil.real, res.pupil.imag]),
                "metrics": np.stack([res.metrics["data_residual"],
                                     res.metrics["update_norm"]], axis=1)}

    with tempfile.TemporaryDirectory(prefix="fpm_chip_smoke_wide_") as tmp:
        fov_path = write_dataset(os.path.join(tmp, "wide"), cfg, geom, wide_frames)
        cfg_fov = load_config(fov_path, iterations=10)
        full = ingest_both(cfg_fov, f"{WIDE}x{WIDE} whole frames", full_frames=True)[0]
        grid, overlap = 8, n // 4
        hr = cfg.res_improvement_factor * (n + (n - overlap) * (grid - 1))
        firsts = {}
        for mode in ("sequential", "batched"):
            key = mode_kernel[mode]
            out = os.path.join(tmp, "fov_" + mode)
            flags = [fov_path, "-n", "10", "-o", out, "--use-pallas", "--chunk-size", "32",
                     "--mode", mode, "--fov-grid", str(grid), str(grid), "--checkpoint-every", "1"]
            wall, counts = run_cli(flags)
            records = read_records(out)
            tiles_logged = [(r["row"], r["col"]) for r in records if r["event"] == "tile"]
            options = next(r for r in records if r["event"] == "solver_options")
            rounds = -(-grid * grid // options["roi_ranks"])
            phase_s = {r["name"]: r["seconds"] for r in records if r["event"] == "phase"}
            stitched = np.load(os.path.join(out, "object_stitched.npy"))
            firsts[mode] = (flags, stitched)
            path_launches[f"fov-grid {mode}"] = counts[key]
            missing = [f for f in ("object_stitched.npy", "object_stitched_amp.png",
                                   "object_stitched_phase.png")
                       if not os.path.exists(os.path.join(out, f))]
            # The ROI runner in this process without a tile store, then the
            # same 64 tiles one after another through reconstruct, on the card.
            fov_kw = dict(grid=(grid, grid), use_pallas=True, mode=mode, chunk_size=32)

            def roi_runner():
                return reconstruct_large_fov_sharded(full.images, full.geom, cfg_fov, **fov_kw)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roi_tiles = roi_runner().tiles
            torch.cuda.synchronize()
            roi_s = time.perf_counter() - t0
            # The stitch (NumPy on the host, fpm_tpu's own) is part of both runs.
            rif = cfg.res_improvement_factor
            t0 = time.perf_counter()
            stitch_fields([t.obj_crop for t in roi_tiles], (grid, grid), n * rif,
                          (n - overlap) * rif, overlap * rif)
            stitch_s = time.perf_counter() - t0
            del roi_tiles
            t0 = time.perf_counter()
            roi_by_kernel = device_ms_by_kernel(roi_runner)
            roi_profiled_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seq = reconstruct_large_fov(full.images, full.geom, cfg_fov, device="cuda", **fov_kw)
            torch.cuda.synchronize()
            tile_after_tile_s = time.perf_counter() - t0
            tiles_equal = sum(
                all(np.array_equal(a, b) for a, b in zip(
                    tile_planes(os.path.join(out, "tiles", f"tile_{i:04d}.npz")).values(),
                    result_planes(t).values()))
                for i, t in enumerate(seq.tiles))
            err = stitched_error(stitched, obj_wide, overlap * cfg.res_improvement_factor)
            emit({"phase": "large_fov", "mode": mode, "grid": [grid, grid], "overlap": overlap,
                  "frames": list(full.images.shape), "tiles": grid * grid,
                  "roi_ranks": options["roi_ranks"], "rounds": rounds,
                  "wall_s": wall, "phase_s": phase_s,
                  "solve_s_roi_path_with_tile_store": phase_s.get("solve"),
                  "solve_s_roi_runner": roi_s, "solve_s_tile_after_tile": tile_after_tile_s,
                  "stitch_s_host": stitch_s,
                  "led_frames_per_s_roi_runner": grid * grid * 10 * k_leds / roi_s,
                  "led_frames_per_s_tile_after_tile":
                      grid * grid * 10 * k_leds / tile_after_tile_s,
                  "roi_runner_device_ms": sum(roi_by_kernel.values()),
                  "roi_runner_device_busy_share": sum(roi_by_kernel.values()) / 1e3
                  / roi_profiled_s,
                  "roi_runner_device_ms_top": dict(list(roi_by_kernel.items())[:6]),
                  "launches": counts, "tile_events": len(tiles_logged),
                  "tiles_bitwise_equal_to_reconstruct": tiles_equal,
                  "stitch_bitwise_equal_to_tile_after_tile":
                      bool(np.array_equal(stitched, seq.stitched)),
                  "stitched_shape": list(stitched.shape), "stitched_amp_error": err,
                  "stitched_error_limit": STITCH_LIMIT, "gpu": smi})
            check(not missing, f"fov-grid {mode} wrote no {missing}")
            check(stitched.shape == (hr, hr) and np.isfinite(stitched).all(),
                  f"fov-grid {mode}: stitch {stitched.shape} not finite of shape {(hr, hr)}")
            check(sorted(tiles_logged) == [(r, c) for r in range(grid) for c in range(grid)],
                  f"fov-grid {mode} logged {len(tiles_logged)} tile events")
            check(counts[key] == per_sweep_launches[key] * 10 * rounds
                  and all(c == 0 for k, c in counts.items() if k != key),
                  f"fov-grid {mode}: launches {counts} for {rounds} round(s) of 10 sweeps")
            check(tiles_equal == grid * grid and np.array_equal(stitched, seq.stitched),
                  f"fov-grid {mode}: {grid * grid - tiles_equal} tiles differ from "
                  "reconstruct on the tile alone")
            check(err < STITCH_LIMIT, f"fov-grid {mode}: stitched error {err} >= {STITCH_LIMIT}")
            del seq

        # Resume: half of the sequential run's tiles deleted, the rest loaded.
        flags, stitched = firsts["sequential"]
        out = flags[flags.index("-o") + 1]
        deleted = list(range(0, grid * grid, 2))
        for i in deleted:
            os.remove(os.path.join(out, "tiles", f"tile_{i:04d}.npz"))
        before = len(read_records(out))
        wall, counts = run_cli(flags + ["--resume"])
        resumed = [(r["row"], r["col"]) for r in read_records(out)[before:] if r["event"] == "tile"]
        again = np.load(os.path.join(out, "object_stitched.npy"))
        emit({"phase": "large_fov", "mode": "sequential, --resume", "tiles_deleted": len(deleted),
              "tile_events": len(resumed), "launches": counts, "wall_s": wall,
              "stitch_bitwise_equal_to_first_run": bool(np.array_equal(again, stitched))})
        check(sorted(resumed) == [divmod(i, grid) for i in deleted],
              f"the resumed run solved {len(resumed)} tiles, not the {len(deleted)} deleted")
        check(np.array_equal(again, stitched), "the resumed stitch differs from the first run's")
    del full, firsts

    # RGB: three objects in the planes of 8-bit RGB frames.
    objs_rgb = [make_test_object(nl, seed=args.seed + c) for c in range(3)]
    planes8 = []
    for obj in objs_rgb:
        inten = simulate_images(obj, geom, cfg, quantize=False)
        planes8.append(np.clip(np.rint(inten * (255.0 / inten.max())), 0, 255).astype(np.uint8))
    with tempfile.TemporaryDirectory(prefix="fpm_chip_smoke_rgb_") as tmp:
        rgb_path = write_dataset(os.path.join(tmp, "rgb"), cfg, geom, np.stack(planes8, axis=-1))
        cfg_rgb = load_config(rgb_path, iterations=10)
        channels = load_dataset_rgb(cfg_rgb)
        for mode in ("sequential", "batched"):
            key = mode_kernel[mode]
            out = os.path.join(tmp, "rgb_" + mode)
            wall, counts = run_cli([rgb_path, "-n", "10", "-o", out, "--use-pallas",
                                    "--chunk-size", "32", "--mode", mode, "--color-mode", "rgb"])
            path_launches[f"rgb {mode}"] = counts[key]
            phase_s = {r["name"]: r["seconds"] for r in read_records(out) if r["event"] == "phase"}
            missing = [f for f in ("object_rgb.png", *(os.path.join(c, f) for c in
                                                      ("red", "green", "blue")
                                                      for f in OUTPUT_FILES[:-1]))
                       if not os.path.exists(os.path.join(out, f))]
            rmse, equal = {}, {}
            for name, ch, obj in zip(("red", "green", "blue"), channels, objs_rgb):
                alone = epry.reconstruct(ch.images, ch.geom, cfg_rgb, iterations=10,
                                         use_pallas=True, mode=mode, chunk_size=32)
                wanted = {"object.npy": alone.obj_crop, "pupil.npy": alone.pupil,
                          "object_spectrum.npy": alone.obj_f_centered}
                equal[name] = all(np.array_equal(np.load(os.path.join(out, name, f)), a)
                                  for f, a in wanted.items())
                rmse[name] = amplitude_rmse(np.load(os.path.join(out, name, "object.npy")), obj)
            emit({"phase": "rgb", "mode": mode, "iterations": 10, "wall_s": wall,
                  "phase_s": phase_s, "launches": counts,
                  "bitwise_equal_to_channel_alone": equal, "amp_rmse": rmse,
                  "rmse_limit": RMSE_LIMIT})
            check(not missing, f"rgb {mode} wrote no {missing}")
            check(counts[key] == per_sweep_launches[key] * 10
                  and all(c == 0 for k, c in counts.items() if k != key),
                  f"rgb {mode}: launches {counts}, not one launch sequence per sweep")
            check(all(equal.values()), f"rgb {mode}: channels differ from solo solves: {equal}")
            check(all(v < RMSE_LIMIT for v in rmse.values()),
                  f"rgb {mode}: amplitude RMSE {rmse} not below {RMSE_LIMIT}")

    # ------------------------------------------------------------ 5. timing
    support_c = sup_r.to(torch.complex64)
    # The eager torch.fft route (the same function at either tier): the
    # library yardstick of K1 and K2.
    library_ms = {
        "K1": cuda_ms(lambda: epry.sweep_batched(o0, p0, amps_it, starts_it, support=support_c,
                                                 opts=opts_b, mask=mask), 2),
        "K2": cuda_ms(lambda: epry.sweep_sequential(o0, p0, amps, starts, support=support_c,
                                                    opts=opts), 2),
    }
    # Each kernel's main-path run at each tier (main_path above).
    main_run = {"K1": "batched", "K2": "sequential", "K3": "mesh 4 1"}

    def main_launches(key, tier):
        return launches[main_run[key] + (" highest" if tier == "highest" else "")]

    rows = []
    for tier in TIERS:
        for key, name, src, replaces in (
                ("K1", "fused_epry_chunked", "fpm_torch/ops/csrc/epry_chunked.cu",
                 "fpm_tpu/ops/pallas_kernels.py:775"),
                ("K2", "fused_epry_sweep", "fpm_torch/ops/csrc/epry_sweep.cu",
                 "fpm_tpu/ops/pallas_kernels.py:1131")):
            kern, plain, rest, extra = cases["K1" if key == "K1" else "K2 exact"]
            extra = dict(extra, dft_precision=tier)

            def sweep():
                return kern(o_planes, p_planes, sup_r, *rest, **common, **extra)

            kern.launches = 0
            sweep()
            per_sweep, cs = kern.launches, kern.cluster_size
            check(key != "K2" or per_sweep <= 2, f"K2 made {per_sweep} launches in one sweep")
            ms = cuda_ms(sweep, 5)
            by_kernel = device_ms_by_kernel(sweep)
            by_cs, device_by_cs = {}, {}
            for forced in (1, 2, 4, 8):
                kern.force_cluster_size = forced
                by_cs[str(forced)] = cuda_ms(sweep, 3)
                device_by_cs[str(forced)] = sum(device_ms_by_kernel(sweep).values())
                kern.force_cluster_size = 0
            # Z cut by rows across the cluster (where whole Z fits, as here,
            # the entry point keeps it whole): the device time of that layout.
            kern.force_z_layout = 2
            device_z_cut = sum(device_ms_by_kernel(sweep).values())
            kern.force_z_layout = 0
            plain_ms = cuda_ms(lambda: plain(o_planes, p_planes, sup_r, *rest, **common, **extra),
                               2)
            nbytes, flops = sweep_work(k_leds, n, b, nl, n_slots if key == "K1" else k_leds,
                                       has_valid=key == "K1")
            bound_ms, bound_by = bound(nbytes, flops)
            err = (errs["K1", tier] if key == "K1"
                   else max(errs["K2 exact", tier], errs["K2 lazy", tier]))
            rows.append({"name": f"{name} [{tier}]", "dft_precision": tier, "route": "cuda",
                         "source": src, "replaces": replaces,
                         "launches": main_launches(key, tier),
                         "launches_per_sweep": per_sweep, "cluster_size": cs,
                         "max_abs_err": err, "ms": ms,
                         "device_ms": sum(by_kernel.values()), "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms[key]})
            emit({"phase": "timing", "kernel": name, "dft_precision": tier, "cluster_size": cs,
                  "blocks_per_forward_launch": cs * (amps_it.shape[1] if key == "K1" else 1),
                  "ms_per_sweep": ms, "ms_per_sweep_by_forced_cluster_size": by_cs,
                  "device_ms_per_sweep_by_forced_cluster_size": device_by_cs,
                  "device_ms_per_sweep_z_cut_by_rows": device_z_cut, "plain_ms": plain_ms, "library_ms": library_ms[key], "bound_ms": bound_ms,
                  "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                  "launches_per_sweep": per_sweep, "led_frames_per_s": k_leds / ms * 1e3,
                  "device_ms_by_kernel": by_kernel,
                  "device_busy_share": sum(by_kernel.values()) / ms, "gpu": smi})

    # The problem axis: P problems per launch at the cluster size the entry
    # point picks (the ROI problems of the wide frames); highest at P = 1, 66.
    for row in rows:
        tier = row["dft_precision"]
        case = "K1" if row["name"].startswith("fused_epry_chunked") else "K2 exact"
        kern, _, frames_p, shared, extra = axis_cases[case]
        extra = dict(extra, dft_precision=tier)
        by_p = {}
        for n_prob in (TIMING_P if tier == "bf16x3" else (1, 66)):
            if n_prob == 1:
                operands = (o_p[0], p_p[0], sup_r, frames_p[0])
            else:
                operands = (o_p[:n_prob], p_p[:n_prob], sup_r, frames_p[:n_prob])

            def sweep():
                return kern(*operands, *shared, **common, **extra)

            kern.launches = 0
            sweep()
            launched, cs = kern.launches, kern.cluster_size
            ms = cuda_ms(sweep, 5 if n_prob <= 16 else 3)
            bound_ms, _ = bound(*(n_prob * w for w in sweep_work(
                k_leds, n, b, nl, n_slots if case == "K1" else k_leds, has_valid=case == "K1")))
            # Every cluster size, forced, and how many clusters of it the
            # card holds at once (CUDA's occupancy query) for these slots.
            slots = n_prob * (amps_it.shape[1] if case == "K1" else 1)
            forced_ms, resident = {}, {}
            for forced in (1, 2, 4, 8):
                kern.force_cluster_size = forced
                forced_ms[str(forced)] = cuda_ms(sweep, 3)
                kern.force_cluster_size = 0
                resident[str(forced)] = kernels.resident_clusters(
                    kern, n, opts.pupil_radius, slots, forced, dft_precision=tier)
            by_p[str(n_prob)] = {"cluster_size": cs, "launches_per_sweep": launched,
                                 "ms_per_sweep": ms, "ms_per_problem_sweep": ms / n_prob,
                                 "led_frames_per_s": n_prob * k_leds / ms * 1e3,
                                 "bound_ms": bound_ms,
                                 "ms_per_sweep_by_forced_cluster_size": forced_ms,
                                 "resident_clusters_by_cluster_size": resident}
        row["problem_axis"] = by_p
        if tier == "bf16x3":
            row["launches_by_path"] = {k: v for k, v in path_launches.items()
                                       if k.endswith("sequential" if case != "K1" else "batched")}
        emit({"phase": "timing", "kernel": row["name"], "dft_precision": tier,
              "problem_axis": by_p, "problems_from": f"Np={n} ROIs of the {WIDE}x{WIDE} frames",
              "gpu": smi})

    # Where K2's time goes inside its one persistent launch, which the
    # profiler sees only whole: the profile build of the kernel counts the SM
    # cycles of each phase of an LED on the cluster's first block.
    k2 = kernels.fused_epry_sweep
    for tier in TIERS:
        k2_extra = dict(cases["K2 exact"][3], dft_precision=tier)

        def k2_profiled():
            return kernels.k2_phase_profile(o_planes, p_planes, sup_r, *k2_rest, **common,
                                            **k2_extra)

        k2_profiled()                                       # built and warm
        (po, pp, _), cycles = k2_profiled()
        ko, kp, _ = k2(o_planes, p_planes, sup_r, *k2_rest, **common, **k2_extra)
        check(torch.equal(po, ko) and torch.equal(pp, kp),
              f"K2's profile build gives another result than the plain build ({tier})")
        check(all(c > 0 for c in cycles.values()),
              f"a phase of K2 counted no cycle ({tier}): {cycles}")
        total = sum(cycles.values())
        emit({"phase": "timing", "kernel": "fused_epry_sweep", "dft_precision": tier,
              "k2_phase_profile": {
                  "cluster_size": k2.cluster_size, "leds": k_leds,
                  "cycles_per_led": total / k_leds,
                  "share_by_phase": {name: c / total for name, c in cycles.items()},
                  "cycles_per_led_by_phase": {name: c / k_leds for name, c in cycles.items()}},
              "gpu": smi})

    # K3 as rank (0,0) of mesh (4,1) calls it: its slice (8 slots) of each of
    # the sweep's 7 chunks, on the whole 360×360 spectrum, init state.
    mesh41 = make_mesh(4, 1)
    route41, opts41 = led_shard.prepare_led_sharded(
        frames, geom, cfg, mesh41, use_pallas=True, chunk_size=32)
    _, r_amps, r_starts, r_valid, _ = (g[0][0] for g in route41.inputs)
    pairs0 = r_starts[0].view(-1, 2)
    n_chunks, c_local = r_valid.shape
    eager41 = dataclasses.replace(opts41, use_pallas=False)
    k3_library_ms = cuda_ms(lambda: led_shard._chunk_increments(
        o0, p0, support_c, r_amps[0], pairs0, r_valid[0].to(torch.float32), opts=eager41), 3)
    n_valid = int(r_valid[0].sum())
    o_elems = window_union(pairs0.tolist(), r_valid[0].tolist(), n, b, lo, nl, nl)
    nbytes, flops = increments_work(n_valid, c_local, n, b, nl, nl, o_elems)
    k3_bound_ms, k3_bound_by = bound(nbytes, flops)
    for tier in TIERS:
        k3_kw = dict(k3_common, n_rows=nl, n_cols=nl, dft_precision=tier)

        def k3_call(fn, c):
            return fn(o_planes, p_planes, sup_r, r_amps[c], r_starts[c], r_valid[c], **k3_kw)

        def k3_sweep(fn):
            for c in range(n_chunks):
                k3_call(fn, c)

        k3.launches = 0
        k3_sweep(k3)
        per_sweep, cs = k3.launches, k3.cluster_size
        ms_call = cuda_ms(lambda: k3_call(k3, 0), 20)
        ms_sweep = cuda_ms(lambda: k3_sweep(k3), 5)
        by_kernel = device_ms_by_kernel(lambda: k3_call(k3, 0))
        plain_ms = cuda_ms(lambda: k3_call(kernels.fused_chunk_increments_plain, 0), 3)
        rows.append({"name": f"fused_chunk_increments [{tier}]", "dft_precision": tier,
                     "route": "cuda", "source": "fpm_torch/ops/csrc/epry_increments.cu",
                     "replaces": "fpm_tpu/ops/pallas_kernels.py:1006",
                     "launches": main_launches("K3", tier), "launches_per_sweep": per_sweep,
                     "cluster_size": cs,
                     "max_abs_err": max(v for (k, t), v in errs.items()
                                        if k.startswith("K3") and t == tier),
                     "ms": ms_call, "device_ms": sum(by_kernel.values()), "plain_ms": plain_ms,
                     "bound_ms": k3_bound_ms, "bound_by": k3_bound_by,
                     "library_ms": k3_library_ms})
        emit({"phase": "timing", "kernel": "fused_chunk_increments", "dft_precision": tier,
              "cluster_size": cs, "blocks_per_forward_launch": cs * c_local,
              "device_ms_per_call": sum(by_kernel.values()),
              "as": "rank (0,0) of mesh (4,1): 8 slots per call on the 360x360 block",
              "ms_per_call": ms_call, "calls_per_sweep": n_chunks,
              "ms_per_sweep_of_calls": ms_sweep, "plain_ms": plain_ms,
              "library_ms": k3_library_ms, "bound_ms": k3_bound_ms, "bound_by": k3_bound_by,
              "bytes": nbytes, "flops": flops, "valid_leds": n_valid,
              "o_bytes_read": 8 * o_elems, "d_bytes_written": 8 * nl * nl,
              "launches_per_sweep": per_sweep, "launches_main_path": {
                  k: v for k, v in launches.items() if k.startswith("mesh")},
              "device_ms_by_kernel": by_kernel, "gpu": smi})

    sharded_sweep_phase({"mono": (cfg, geom, frames),
                         "dogStomach": sharded_problem("dogStomach", args.seed)},
                        digests["sharded"], sharded_entry_timing(args.seed), smi)

    rows += dogstomach(args.seed, smi, dev)

    # ------------------------------------- 7-9. oracle, debug, distributed
    oracle_phase(cfg, geom, frames, smi)
    with tempfile.TemporaryDirectory(prefix="fpm_chip_smoke_dist_") as tmp:
        debug_phase(cfg, geom, frames, smi, tmp)
        distributed_phase(cfg, geom, frames, wide_frames, smi, tmp)

    # ------------------------------------------------------------ 10. bench
    ablation = bench_phase(args.seed, smi, o_planes, p_planes, sup_r, cases, common)

    # -------------------------------------------------------- 11. benchmark
    benchmark_phase(smi)

    # ---------------------------------------------------------- 12. surface
    surface_phase(cfg, geom, frames, smi)
    for row in rows:   # the mono rows of K1 and K2: the shape phase 10 held the builds at
        for key, name in (("K1", "fused_epry_chunked"), ("K2", "fused_epry_sweep")):
            if row["name"] == f"{name} [{row['dft_precision']}]":
                row["ablation_build"] = ablation[key]
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
