"""CLI driver of the PyTorch port (the reference's ``main()``,
fpmMain.cpp:500-592), with the flag set of ``python -m fpm_tpu``:

    python -m fpm_torch run dataset.json -n 10 -o out/ --use-pallas   # on the GPU
    python -m fpm_torch run dataset.json -n 10 --platform cpu          # on the CPU
    python -m fpm_torch run dataset.json -n 10 --use-pallas --mesh 2 2 # (led, tile) mesh
    python -m fpm_torch run dataset.json -n 10 --use-pallas --fov-grid 8 8  # large FOV
    python -m fpm_torch run dataset.json -n 10 --use-pallas --color-mode rgb
    python -m fpm_torch info dataset.json
    python -m fpm_torch simulate out_dir/ --np-size 32

``--platform cuda`` (the default) runs on the GPU, where the sweep goes
through the port's CUDA kernels and so needs ``--use-pallas``; ``--platform
cpu`` runs on the CPU. ``--mesh LED TILE`` (or the config's ``tileGrid`` key)
runs the LED-sharded (TILE = 1) or tile-sharded sweep of ``fpm_torch.parallel``
on a mesh of LED·TILE ranks, placed round-robin over the visible GPUs (on a
one-GPU machine they share it) or, with ``--platform cpu``, on the CPU.
``--fov-grid R C`` tiles whole camera frames into R×C overlapping ROIs and
stitches them: on the GPU in rounds of tiles, the tiles of a round that
share a card in ONE problem-axis launch per sweep (``parallel/roi_shard.py``),
on the CPU tile after tile. ``--color-mode rgb`` decodes each file once and
solves the three channels together (one launch per sweep on the GPU).
``--watchdog-timeout S`` aborts a run that makes no progress for S seconds
(armed before the first chunk, after the kernels are built).
``--dft-precision`` picks the kernels' DFT products: ``bf16x3`` (the default,
as in ``fpm_tpu``: a 3-pass bf16 split on the tensor cores) or ``highest``
(FP32); the eager route has no such products and ignores it, as ``fpm_tpu``
does. The frames are decoded by the native C++ decoder where it builds and
the files are TIFF, else by PIL (``--no-native`` forces PIL; the arrays are
the same). ``--debug`` dumps the spectrum and pupil of every sweep and the
center LED's frame as PNGs under ``out/debug/`` (the reference's ``debug``
windows), ``--debug-led K`` with it also the six working spectra of schedule
position K, replayed on the run's device (``models.epry.led_intermediates``).
``--distributed`` runs one process of a multi-process run
(``parallel.multihost``: ``FPM_COORDINATOR``/``FPM_NUM_PROCESSES``/
``FPM_PROCESS_ID``, or torchrun's environment): ``--mesh`` spans the
processes, ``--fov-grid`` deals each round's tiles between them, and only
process 0 writes metrics, checkpoints and results:

    FPM_COORDINATOR=host0:29400 FPM_NUM_PROCESSES=2 FPM_PROCESS_ID=<0|1> \
        python -m fpm_torch run dataset.json -n 10 --use-pallas --distributed --mesh 2 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_run_parser(sub):
    p = sub.add_parser("run", help="run a reconstruction from a dataset_*.json")
    p.add_argument("config", help="dataset descriptor JSON (reference schema)")
    p.add_argument("iterations_pos", nargs="?", type=int, default=None,
                   help="iteration count (reference argv[2] style)")
    p.add_argument("-n", "--iterations", type=int, default=None)
    p.add_argument("-o", "--output", default="fpm_output")
    p.add_argument("--mode", choices=["sequential", "batched"], default="sequential")
    p.add_argument("--global-max", choices=["exact", "lazy"], default="exact")
    p.add_argument("--chunk-size", type=int, default=32,
                   help="batched mode: LEDs per Jacobi chunk (0 = whole sweep; "
                        "unstable at realistic LED counts)")
    p.add_argument("--chunk-assign", choices=["strided", "contiguous"],
                   default="strided",
                   help="batched mode: chunk makeup over the NA-sorted schedule")
    p.add_argument("--dtype", default=None,
                   help="complex64 (default) or complex128 (CPU parity runs)")
    p.add_argument("--platform", choices=["cpu", "cuda"], default=None,
                   help="device: cuda (default) or cpu")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a checkpoint every K iterations (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the output dir")
    p.add_argument("--resume-unsafe", action="store_true",
                   help="with --resume: downgrade a provenance-fingerprint "
                        "mismatch to a warning")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--trace-dir", default=None, help="write a torch.profiler trace")
    p.add_argument("--debug", action="store_true",
                   help="dump intermediate spectra PNGs per sweep (the reference's "
                        "'debug' windows, fpmMain.cpp:352-455), plus the center-LED "
                        "frame (fpmMain.cpp:543); keeps the traceback of an error")
    p.add_argument("--debug-led", type=int, default=None, metavar="K",
                   help="with --debug: also dump the six per-LED working spectra "
                        "of schedule position K every sweep (fpmMain.cpp:366-455)")
    p.add_argument("--no-native", action="store_true", help="force the Python (PIL) loader")
    p.add_argument("--fov-grid", type=int, nargs=2, metavar=("R", "C"), default=None,
                   help="large field of view: reconstruct an R x C grid of "
                        "overlapping Np x Np ROIs of the whole frames and stitch "
                        "them (object_stitched.npy); --checkpoint-every > 0 or "
                        "--resume keeps each solved tile under out/tiles/")
    p.add_argument("--fov-overlap", type=int, default=None,
                   help="camera-pixel overlap of neighbouring ROIs for "
                        "--fov-grid (default Np // 4)")
    p.add_argument("--color-mode", choices=["single", "rgb"], default="single",
                   help="'single' keeps one channel like the reference; 'rgb' "
                        "decodes each file once and reconstructs R, G and B")
    p.add_argument("--use-pallas", action="store_true",
                   help="run the sweep through the port's CUDA kernels (K1 "
                        "batched, K2 sequential, K3 on a mesh); on --platform "
                        "cpu, through their plain PyTorch versions")
    p.add_argument("--dft-precision", choices=["bf16x3", "highest"],
                   default="bf16x3",
                   help="kernels' DFT products: 3-pass bf16 split on the tensor "
                        "cores (~1e-6 rel err) or exact FP32")
    p.add_argument("--mesh", type=int, nargs=2, metavar=("LED", "TILE"),
                   default=None,
                   help="run on an LED x TILE mesh of ranks (batched sweep "
                        "semantics): TILE = 1 shards each chunk's LEDs, TILE > 1 "
                        "also row-shards the spectrum; ranks go round-robin over "
                        "the visible GPUs and may share one")
    p.add_argument("--comm-precision", choices=["f32", "bf16"], default="f32",
                   help="mesh runs: consensus payload precision (bf16 halves "
                        "every psum and reverse-halo payload; needs --use-pallas)")
    p.add_argument("--stale-consensus", action="store_true",
                   help="mesh runs: compute chunk c+1's increments before chunk "
                        "c's consensus is applied (one chunk stale)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize torch.distributed from FPM_COORDINATOR/"
                        "FPM_NUM_PROCESSES/FPM_PROCESS_ID (or torchrun's "
                        "environment): one process of a multi-process run")
    p.add_argument("--watchdog-timeout", type=float, default=0,
                   help="abort the process (exit 42) after this many seconds "
                        "without progress (0 = off); resume from the latest "
                        "checkpoint or tiles")
    return p


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="fpm_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_run_parser(sub)

    p_info = sub.add_parser("info", help="print derived optical parameters")
    p_info.add_argument("config")
    p_info.add_argument("--geometry", action="store_true",
                        help="also print the per-LED geometry table as JSON lines")

    p_sim = sub.add_parser("simulate", help="write a synthetic dataset to disk")
    p_sim.add_argument("out_dir")
    p_sim.add_argument("--np-size", type=int, default=32)
    p_sim.add_argument("--grid", type=int, default=7)
    p_sim.add_argument("--seed", type=int, default=0)
    p_sim.add_argument("--frame-size", type=int, default=None,
                       help="simulate full camera frames of this size (> np-size)")
    p_sim.add_argument("--jitter", type=float, default=0.0,
                       help="deterministic LED-position jitter as a fraction of "
                            "grid spacing (makes the NA schedule unique)")
    p_sim.add_argument("--darkfield-exp", type=int, default=1,
                       help="darkfieldExpMultiplier written into the frames and "
                            "dataset.json")

    args = parser.parse_args(argv)
    try:
        if args.cmd == "run":
            return _cmd_run(args)
        if args.cmd == "info":
            return _cmd_info(args)
        if args.cmd == "simulate":
            return _cmd_simulate(args)
    except (OSError, ValueError) as e:
        # Clean one-line errors (the reference printed "ERROR: Could not
        # Open Directory." and friends, fpmMain.cpp:266-270). Under --debug
        # the full traceback is kept: a disk-full or permission failure
        # mid-run needs its context to be diagnosable.
        if getattr(args, "debug", False):
            raise
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    return 2


def _cmd_info(args) -> int:
    from .config import load_config
    from .geometry import pupil_radius

    cfg = load_config(args.config)
    out = {
        "Np": cfg.np_size,
        "ps_eff": cfg.ps_eff,
        "du": cfg.du,
        "resImprovementFactor": cfg.res_improvement_factor,
        "Nlarge": cfg.n_large,
        "recovered_pixel_size": cfg.recovered_pixel_size,
        "ledCount": cfg.led_count,
        "pupil_radius_px": pupil_radius(cfg),
    }
    print(json.dumps(out, indent=2))
    if args.geometry:
        import numpy as np

        from .geometry import compute_geometry

        geom = compute_geometry(cfg)
        for i in range(geom.num_leds):
            print(json.dumps({
                "led": int(geom.led_numbers[i]),
                "sinTheta_x": float(geom.sin_theta[i, 0]),
                "sinTheta_y": float(geom.sin_theta[i, 1]),
                "illumination_na": float(geom.illumination_na[i]),
                "idx_u": int(geom.idx_uv[i, 0]),
                "idx_v": int(geom.idx_uv[i, 1]),
                "cropYStart": int(geom.crop_start[i, 0]),
                "cropXStart": int(geom.crop_start[i, 1]),
                "cropSize": cfg.np_size,
                "darkfield": bool(geom.is_darkfield[i]),
                "schedule_position": int(np.argmax(geom.schedule == i)),
            }))
    return 0


def _cmd_simulate(args) -> int:
    import numpy as np
    from PIL import Image

    from .data.simulate import synthetic_dataset

    if args.grid < 1:
        raise ValueError(f"--grid must be >= 1, got {args.grid}")
    if args.np_size < 4:
        raise ValueError(f"--np-size must be >= 4, got {args.np_size}")
    sim_size = args.frame_size or args.np_size
    if sim_size < args.np_size:
        raise ValueError("--frame-size must be >= --np-size")
    ds = synthetic_dataset(np_size=sim_size, grid=args.grid, seed=args.seed,
                           quantize=True, raw_frames=True, jitter=args.jitter,
                           darkfield_exp_multiplier=args.darkfield_exp)
    os.makedirs(args.out_dir, exist_ok=True)
    # The reference's file layout ({prefix}{led#}{ext}), so the full
    # scan/decode ingestion path runs on it.
    for i, led in enumerate(ds.geom.led_numbers):
        Image.fromarray(ds.images[i].astype(np.uint16)).save(
            os.path.join(args.out_dir, f"iLED_{led}.tif")
        )
    cfg_doc = {
        "datasetRoot": os.path.abspath(args.out_dir) + os.sep,
        "filePrefix": "iLED_",
        "fileExtension": ".tif",
        "cropSizeX": args.np_size,
        "pixelSize": ds.cfg.pixel_size,
        "objectiveMag": ds.cfg.objective_mag,
        "objectiveNA": ds.cfg.objective_na,
        "maxIlluminationNA": ds.cfg.max_illumination_na,
        "lambda": ds.cfg.wavelength,
        "cropX": 0, "cropY": 0,
        "bk1cropX": 0, "bk1cropY": 0, "bk2cropX": 0, "bk2cropY": 0,
        "bgThresh": 0,
        "darkfieldExpMultiplier": args.darkfield_exp,
        "delta1": ds.cfg.delta1, "delta2": ds.cfg.delta2,
        "ledCount": int(ds.cfg.led_count),
        "holeCoordinates": [
            [{"x": float(x)}, {"y": float(y)}, {"z": float(z)}]
            for x, y, z in ds.cfg.hole_coordinates
        ],
    }
    cfg_path = os.path.join(args.out_dir, "dataset.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg_doc, f)
    np.save(os.path.join(args.out_dir, "object_true.npy"), ds.object_true)
    print(f"wrote {ds.geom.num_leds} LED frames + {cfg_path}")
    return 0


def _cmd_run(args) -> int:
    if not args.distributed:
        args.coordinator = True
        return _run(args)
    from .parallel.multihost import initialize_from_env, is_coordinator, shutdown

    initialize_from_env(require=True)
    try:
        # One process owns the output directory (metrics, checkpoints,
        # results): concurrent writers would tear the atomic checkpoint
        # rename and interleave the metrics stream.
        args.coordinator = is_coordinator()
        return _run(args)
    finally:
        shutdown()


def _run(args) -> int:
    if args.fov_grid and args.color_mode == "rgb":
        raise ValueError("--fov-grid and --color-mode rgb are not supported "
                         "together (tile the channels as separate runs)")
    if args.mesh and args.color_mode == "rgb":
        raise ValueError("--color-mode rgb does not support --mesh (the three "
                         "channels already batch in one program)")
    if args.mesh and args.fov_grid:
        raise ValueError("--fov-grid auto-shards ROIs over all devices; --mesh is "
                         "not supported with it")
    import numpy as np
    import torch

    from .config import load_config
    from .utils.metrics import MetricsLogger
    from .utils.profiling import trace

    device = args.platform or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise ValueError("no CUDA device is available; pass --platform cpu to run "
                         "on the CPU")

    iterations = args.iterations if args.iterations is not None else args.iterations_pos
    cfg = load_config(args.config, iterations=iterations)
    if cfg.iterations < 1:
        raise ValueError(f"iteration count must be >= 1, got {cfg.iterations}")
    if args.dtype:
        try:
            dt = np.dtype(args.dtype)
        except TypeError:
            raise ValueError(f"unknown --dtype {args.dtype!r}") from None
        if dt not in (np.dtype(np.complex64), np.dtype(np.complex128)):
            raise ValueError(
                f"--dtype must be complex64 or complex128, got {args.dtype!r} "
                "(the solver state is complex; real dtypes would discard phase)"
            )
        cfg.dtype = dt.name
    if args.debug:
        cfg.debug = True

    os.makedirs(args.output, exist_ok=True)
    logger = MetricsLogger(
        (args.metrics_jsonl or os.path.join(args.output, "metrics.jsonl"))
        if args.coordinator else None, resume=bool(args.resume))
    watchdog = _RunWatchdog(args.watchdog_timeout, build_kernels=(
        device == "cuda" and args.use_pallas))
    try:
        logger.log("config", path=os.path.abspath(args.config), iterations=cfg.iterations,
                   n_large=cfg.n_large, np_size=cfg.np_size, device=device)
        with trace(args.trace_dir):
            run = (_run_large_fov if args.fov_grid
                   else _run_rgb if args.color_mode == "rgb" else _run_single)
            message = run(args, cfg, logger, device, watchdog)
    finally:
        watchdog.stop()
        logger.close()
    print(f"[fpm-torch] {message}")
    return 0


class _RunWatchdog:
    """``--watchdog-timeout`` for one run (a timeout of 0: nothing). Each
    path calls :meth:`arm` just before its solve, once ingest is done: the
    kernels are built first (nvcc at first use takes seconds and is no
    stall), then the stall clock starts, so a run that hangs in its first
    chunk is caught too. :meth:`beat` after every chunk or tile."""

    def __init__(self, timeout: float, build_kernels: bool):
        self.timeout, self.build_kernels, self.dog = timeout, build_kernels, None

    def arm(self) -> None:
        if self.timeout <= 0:
            return
        from .utils.watchdog import Watchdog

        if self.build_kernels:
            from .ops import build

            build.build_all()
        self.dog = Watchdog(self.timeout).start()

    def beat(self) -> None:
        if self.dog is not None:
            self.dog.beat()

    def stop(self) -> None:
        if self.dog is not None:
            self.dog.stop()


def _resume_state(args, run_fp):
    """``(initial_state, start_iter)`` from the latest checkpoint when
    ``--resume`` finds one (fingerprint-checked), else ``(None, 0)``."""
    from .utils.checkpoint import latest_checkpoint, load_checkpoint

    if args.resume:
        ck = latest_checkpoint(args.output)
        if ck:
            obj_f, pupil, start_iter = load_checkpoint(ck, expect=run_fp,
                                                       strict=not args.resume_unsafe)
            print(f"[fpm-torch] resuming from {ck} (iteration {start_iter})")
            return (obj_f, pupil), start_iter
    return None, 0


def _solve_in_chunks(args, cfg, watchdog, run_fp, initial_state, start_iter, run_chunk,
                     log_chunk, state_of, debug=None):
    """The sweep loop of the single and RGB paths: ``--checkpoint-every``
    sweeps per ``run_chunk(step, initial_state)`` call (one with ``debug``,
    a :class:`_DebugDumps`, around each), a watchdog beat and a log record
    after each, a checkpoint where due (by the coordinator). Returns the
    last result."""
    from .utils.checkpoint import save_checkpoint

    total = cfg.iterations
    if start_iter >= total:
        raise ValueError(
            f"checkpoint is already at iteration {start_iter} >= the "
            f"requested total {total}; nothing to resume (raise -n to "
            "extend the run)")
    chunk = args.checkpoint_every if args.checkpoint_every > 0 else total
    if debug is not None:
        chunk = 1
    result, done = None, start_iter
    watchdog.arm()
    while done < total:
        step = min(chunk, total - done)
        if debug is not None:
            debug.before(done, initial_state)
        result = run_chunk(step, initial_state)
        done += step
        watchdog.beat()
        initial_state = state_of(result)
        log_chunk(done, result)
        if debug is not None:
            debug.after(done, result)
        if (args.coordinator and args.checkpoint_every > 0 and done < total
                and (done - start_iter) % args.checkpoint_every == 0):
            save_checkpoint(os.path.join(args.output, f"ckpt_{done}.npz"),
                            initial_state[0], initial_state[1], done, meta=run_fp)
    return result


def _log_dft_precision(args) -> None:
    """The kernel route's tier, said once per run (``fpm_tpu``'s line)."""
    if args.use_pallas and args.dft_precision == "bf16x3":
        print("[fpm-torch] kernel DFT precision: bf16x3 (~1e-6 rel err; "
              "--dft-precision highest for exact f32)")


def _solver_kwargs(args) -> dict:
    return dict(mode=args.mode, global_max=args.global_max, chunk_size=args.chunk_size,
                chunk_assign=args.chunk_assign, use_pallas=args.use_pallas,
                dft_precision=args.dft_precision)


def _run_single(args, cfg, logger, device, watchdog) -> str:
    from .data.loader import load_dataset
    from .models.epry import effective_chunk_size, reconstruct
    from .utils.checkpoint import fingerprint
    from .utils.outputs import save_results
    from .utils.profiling import phase

    with phase("ingest", logger):
        dataset = load_dataset(cfg, use_native=False if args.no_native else None)
    logger.log("dataset", leds=int(dataset.geom.num_leds), decoder=dataset.decoder,
               fallback_files=dataset.fallback_files)
    print(f"[fpm-torch] loaded {dataset.geom.num_leds} LED frames "
          f"(Np={cfg.np_size}, Nlarge={cfg.n_large})")

    # --mesh, or the config's tileGrid key, resolved before the fingerprint
    # so that provenance records what runs: a mesh run always has batched
    # (chunked-Jacobi) sweep semantics.
    mesh_req = args.mesh or (
        list(cfg.tile_grid) if tuple(cfg.tile_grid) != (1, 1) else None)
    effective_mode = "batched" if mesh_req else args.mode
    # Provenance: everything that changes the iteration trajectory, with the
    # chunk that will actually run (a pure LED mesh rounds it up to a
    # multiple of its led axis). The keys match fpm_tpu's, so checkpoints
    # carry over between the packages.
    n_led_fp = mesh_req[0] if (mesh_req and mesh_req[1] == 1) else 1
    eff_chunk = effective_chunk_size(cfg.np_size, args.chunk_size,
                                     int(dataset.geom.num_leds), bool(args.use_pallas),
                                     effective_mode, n_led=n_led_fp)
    run_fp = fingerprint(
        cfg, dataset.geom, mode=effective_mode, chunk_size=eff_chunk,
        chunk_assign=args.chunk_assign, global_max=args.global_max,
        use_pallas=bool(args.use_pallas), dft_precision=args.dft_precision,
        comm_precision=args.comm_precision, stale_consensus=bool(args.stale_consensus),
        mesh="x".join(map(str, mesh_req)) if mesh_req else None,
    )
    logger.log("solver_options", mode=effective_mode, chunk_size=eff_chunk,
               chunk_assign=args.chunk_assign, global_max=args.global_max,
               use_pallas=bool(args.use_pallas), dft_precision=args.dft_precision,
               comm_precision=args.comm_precision,
               stale_consensus=bool(args.stale_consensus),
               mesh=list(mesh_req) if mesh_req else None, device=device)
    initial_state, start_iter = _resume_state(args, run_fp)
    _log_dft_precision(args)
    solver_kwargs = {k: v for k, v in _solver_kwargs(args).items() if k != "mode"}
    if mesh_req:
        from .parallel import make_mesh, reconstruct_led_sharded, reconstruct_tile_sharded

        n_ranks = mesh_req[0] * mesh_req[1]
        mesh = make_mesh(led=mesh_req[0], tile=mesh_req[1],
                         devices=["cpu"] * n_ranks if device == "cpu" else None)
        print(f"[fpm-torch] mesh: {mesh.describe()}")
        # TILE = 1: pure LED-batch sharding (replicated spectrum).
        sharded = (reconstruct_led_sharded if mesh_req[1] == 1
                   else reconstruct_tile_sharded)

        def run_chunk(step, initial_state):
            return sharded(dataset.images, dataset.geom, cfg, mesh=mesh,
                           iterations=step, initial_state=initial_state,
                           comm_precision=args.comm_precision,
                           stale_consensus=args.stale_consensus, **solver_kwargs)
    else:
        def run_chunk(step, initial_state):
            return reconstruct(dataset.images, dataset.geom, cfg, iterations=step,
                               initial_state=initial_state, device=device,
                               mode=args.mode, **solver_kwargs)

    def log_chunk(done, result):
        logger.log("iterations", done=done,
                   data_residual=float(result.metrics["data_residual"][-1]),
                   update_norm=float(result.metrics["update_norm"][-1]))

    with phase("solve", logger):
        debug = _DebugDumps(args, cfg, dataset, device) if cfg.debug else None
        result = _solve_in_chunks(args, cfg, watchdog, run_fp, initial_state,
                                  start_iter, run_chunk, log_chunk,
                                  lambda r: (r.obj_f_centered, r.pupil), debug=debug)
    if args.coordinator:
        with phase("output", logger):
            save_results(result, args.output, cfg)
    return f"results written to {args.output}"


class _DebugDumps:
    """``--debug`` (or the config's ``debug`` key) on the single path, as
    ``fpm_tpu``'s CLI dumps it: one sweep per solver call; after each,
    ``iter{n:04d}_objF_mag.png`` and ``_pupil_mag.png``; with ``--debug-led
    K`` before each, the six working spectra of schedule position K at that
    sweep's entry state (``iter{n:04d}_led{K:04d}_<stage>_mag.png``),
    replayed on the run's device; and once the center LED's frame,
    ``center_led_<id>.png``. Only the coordinator writes (and replays)."""

    def __init__(self, args, cfg, dataset, device):
        self.cfg, self.dataset, self.device = cfg, dataset, device
        self.led = args.debug_led
        self.dir = os.path.join(args.output, "debug") if args.coordinator else None
        if self.dir is None:
            return
        import numpy as np

        from .utils.outputs import save_png

        os.makedirs(self.dir, exist_ok=True)
        self.entry = None
        if self.led is not None:
            # The first sweep's entry state for the replays: the init
            # contract (fpmMain.cpp:301-343) at complex64, as fpm_tpu's is.
            import torch

            from .geometry import pupil_support
            from .models.epry import (
                EPRYOptions,
                _sorted_device_inputs,
                init_traced,
                state_to_numpy,
            )

            opts = EPRYOptions.from_config(cfg, dtype="complex64", collect_metrics=False)
            amps, _ = _sorted_device_inputs(dataset.images, dataset.geom, torch.complex64,
                                            device)
            support_r = torch.as_tensor(pupil_support(cfg, centered=False),
                                        dtype=torch.float32, device=amps.device)
            self.entry = state_to_numpy(*init_traced(amps, support_r, opts))
        where = np.nonzero(dataset.geom.led_numbers == cfg.center_led)[0]
        if where.size:
            frame = np.asarray(dataset.images[int(where[0])], np.float64)
            save_png(os.path.join(self.dir, f"center_led_{cfg.center_led}.png"),
                     frame / (frame.max() + 1e-30))
        else:
            print(f"[fpm-torch] debug: centerLED {cfg.center_led} not in the loaded "
                  "stack; skipping its debug image")

    def before(self, done: int, state) -> None:
        if self.dir is None or self.led is None:
            return
        from .models.epry import led_intermediates
        from .utils.outputs import SHOW_COMPLEX_MAG, save_complex_img

        inter = led_intermediates(state if state is not None else self.entry,
                                  self.dataset.images, self.dataset.geom, self.cfg, self.led,
                                  device=self.device)
        base = os.path.join(self.dir, f"iter{done + 1:04d}_led{self.led:04d}")
        for name, arr in inter.items():
            save_complex_img(arr, SHOW_COMPLEX_MAG, f"{base}_{name}")

    def after(self, done: int, result) -> None:
        if self.dir is None:
            return
        import numpy as np

        from .utils.outputs import SHOW_COMPLEX_MAG, save_complex_img

        base = os.path.join(self.dir, f"iter{done:04d}")
        save_complex_img(result.obj_f_centered, SHOW_COMPLEX_MAG, base + "_objF")
        save_complex_img(np.fft.fftshift(result.pupil), SHOW_COMPLEX_MAG, base + "_pupil")


def _run_large_fov(args, cfg, logger, device, watchdog) -> str:
    import numpy as np

    from .data.loader import load_dataset
    from .models.epry import effective_chunk_size
    from .models.largefov import reconstruct_large_fov
    from .utils.checkpoint import TileStore, fingerprint
    from .utils.outputs import SHOW_AMP_PHASE, save_complex_img
    from .utils.profiling import phase

    with phase("ingest", logger):
        dataset = load_dataset(cfg, use_native=False if args.no_native else None,
                               full_frames=True)
    logger.log("dataset", leds=int(dataset.geom.num_leds), decoder=dataset.decoder,
               fallback_files=dataset.fallback_files)
    rows, cols = args.fov_grid
    eff_chunk = effective_chunk_size(cfg.np_size, args.chunk_size,
                                     int(dataset.geom.num_leds), bool(args.use_pallas),
                                     args.mode)
    solver_kwargs = _solver_kwargs(args)
    # Per-tile fault tolerance: --checkpoint-every > 0 or --resume keeps each
    # solved tile under out/tiles/, and --resume loads the stored tiles
    # (fingerprint-checked) instead of solving them again. A stored tile is a
    # COMPLETE solve, so the iteration count is part of its fingerprint. The
    # keys are fpm_tpu's: tiles resume across the packages.
    run_fp = fingerprint(
        cfg, dataset.geom, fov_grid=f"{rows}x{cols}", iterations=int(cfg.iterations),
        fov_overlap=args.fov_overlap, mode=args.mode, chunk_size=eff_chunk,
        chunk_assign=args.chunk_assign, global_max=args.global_max,
        use_pallas=bool(args.use_pallas), dft_precision=args.dft_precision,
    )
    # The store exists on every process, so all read the same stored tiles
    # and agree on what is left to solve; only the coordinator writes it.
    tile_store = None
    if args.checkpoint_every > 0 or args.resume:
        tile_store = TileStore(os.path.join(args.output, "tiles"), meta=run_fp,
                               resume=bool(args.resume), strict=not args.resume_unsafe,
                               write=args.coordinator)

    def on_tile(r, c, t):
        logger.log("tile", row=r, col=c, data_residual=float(t.metrics["data_residual"][-1]))
        watchdog.beat()

    common = dict(grid=(rows, cols), overlap=args.fov_overlap, progress=on_tile,
                  tile_store=tile_store, **solver_kwargs)
    with phase("solve", logger):
        watchdog.arm()
        if device == "cuda" or args.distributed:
            from .parallel.roi_shard import (
                make_roi_mesh,
                reconstruct_large_fov_sharded,
                tile_bytes,
            )

            mesh = make_roi_mesh(devices=["cpu"] if device == "cpu" else None,
                                 bytes_per_tile=tile_bytes(cfg, dataset.geom.num_leds))
            print(f"[fpm-torch] large-FOV: {rows}x{cols} tiles of Np={cfg.np_size} in "
                  f"rounds of {mesh.size} ({mesh.describe()})")
            logger.log("solver_options", fov_grid=[rows, cols], roi_ranks=mesh.size,
                       roi_devices=len(set(mesh.ranks)),
                       **{**solver_kwargs, "chunk_size": eff_chunk})
            res = reconstruct_large_fov_sharded(dataset.images, dataset.geom, cfg,
                                                mesh=mesh, **common)
        else:
            print(f"[fpm-torch] large-FOV: {rows}x{cols} tiles of Np={cfg.np_size}")
            res = reconstruct_large_fov(dataset.images, dataset.geom, cfg, device=device,
                                        **common)
    if args.coordinator:
        with phase("output", logger):
            np.save(os.path.join(args.output, "object_stitched.npy"), res.stitched)
            save_complex_img(res.stitched, SHOW_AMP_PHASE,
                             os.path.join(args.output, "object_stitched"))
    return f"stitched {rows * cols} tiles -> {args.output}"


def _run_rgb(args, cfg, logger, device, watchdog) -> str:
    import numpy as np

    from .data.loader import load_dataset_rgb
    from .models.epry import effective_chunk_size, reconstruct_channels
    from .utils.checkpoint import fingerprint
    from .utils.outputs import save_png, save_results
    from .utils.profiling import phase

    # Decode-once ingest: every file is read and decoded once and the three
    # channels are preprocessed from that decode (bitwise three per-channel
    # loads), at the price of holding the three channel stacks at once.
    with phase("ingest[rgb]", logger):
        channels = load_dataset_rgb(cfg, use_native=False if args.no_native else None)
    geom = channels[0].geom
    logger.log("dataset", leds=int(geom.num_leds), decoder=channels[0].decoder,
               fallback_files=channels[0].fallback_files)
    eff_chunk = effective_chunk_size(cfg.np_size, args.chunk_size, int(geom.num_leds),
                                     bool(args.use_pallas), args.mode)
    solver_kwargs = _solver_kwargs(args)
    run_fp = fingerprint(
        cfg, geom, color_mode="rgb", mode=args.mode, chunk_size=eff_chunk,
        chunk_assign=args.chunk_assign, global_max=args.global_max,
        use_pallas=bool(args.use_pallas), dft_precision=args.dft_precision,
    )
    logger.log("solver_options", color_mode="rgb", channels=3, chunk_size=eff_chunk,
               **{k: v for k, v in solver_kwargs.items() if k != "chunk_size"})
    # The sweep checkpoints hold the stacked (3, ...) channel state.
    initial_state, start_iter = _resume_state(args, run_fp)

    def run_chunk(step, initial_state):
        return reconstruct_channels([d.images for d in channels], geom, cfg, iterations=step,
                                    initial_state=initial_state, device=device,
                                    **solver_kwargs)

    def log_chunk(done, results):
        logger.log("iterations", done=done, **{
            name: float(r.metrics["data_residual"][-1])
            for name, r in zip(("red", "green", "blue"), results)})

    with phase("solve[rgb]", logger):
        results = _solve_in_chunks(
            args, cfg, watchdog, run_fp, initial_state, start_iter, run_chunk,
            log_chunk, lambda rs: (np.stack([r.obj_f_centered for r in rs]),
                                   np.stack([r.pupil for r in rs])))
    if args.coordinator:
        amps = []
        for name, res, dataset in zip(("red", "green", "blue"), results, channels):
            save_results(res, os.path.join(args.output, name), dataset.cfg)
            amps.append(np.abs(res.obj_crop))
        rgb = np.stack(amps, axis=-1)
        save_png(os.path.join(args.output, "object_rgb.png"), rgb / (rgb.max() + 1e-30))
    return f"RGB reconstruction -> {args.output}"


if __name__ == "__main__":
    sys.exit(main())
