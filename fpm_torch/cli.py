"""CLI driver of the PyTorch port (the reference's ``main()``,
fpmMain.cpp:500-592), with the flag set of ``python -m fpm_tpu``:

    python -m fpm_torch run dataset.json -n 10 -o out/ --use-pallas   # on the GPU
    python -m fpm_torch run dataset.json -n 10 --platform cpu          # on the CPU
    python -m fpm_torch run dataset.json -n 10 --use-pallas --mesh 2 2 # (led, tile) mesh
    python -m fpm_torch info dataset.json
    python -m fpm_torch simulate out_dir/ --np-size 32

``--platform cuda`` (the default) runs on the GPU, where the sweep goes
through the port's CUDA kernels and so needs ``--use-pallas``; ``--platform
cpu`` runs on the CPU. ``--mesh LED TILE`` (or the config's ``tileGrid`` key)
runs the LED-sharded (TILE = 1) or tile-sharded sweep of ``fpm_torch.parallel``
on a mesh of LED·TILE ranks, placed round-robin over the visible GPUs (on a
one-GPU machine they share it) or, with ``--platform cpu``, on the CPU. Flags
of paths not yet ported (multi-process ``--distributed``, large-FOV tiling,
RGB, debug dumps, the watchdog, the native decoder) are accepted by the parser
and refused with an error naming them.
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
    p.add_argument("--debug", action="store_true", help="(not yet ported)")
    p.add_argument("--debug-led", type=int, default=None, metavar="K",
                   help="(not yet ported)")
    p.add_argument("--no-native", action="store_true", help="(not yet ported)")
    p.add_argument("--fov-grid", type=int, nargs=2, metavar=("R", "C"), default=None,
                   help="(not yet ported) large-FOV ROI grid")
    p.add_argument("--fov-overlap", type=int, default=None,
                   help="(not yet ported) ROI overlap for --fov-grid")
    p.add_argument("--color-mode", choices=["single", "rgb"], default="single",
                   help="'single' keeps one channel like the reference; "
                        "'rgb' is not yet ported")
    p.add_argument("--use-pallas", action="store_true",
                   help="run the sweep through the port's CUDA kernels (K1 "
                        "batched, K2 sequential, K3 on a mesh); on --platform "
                        "cpu, through their plain PyTorch versions")
    p.add_argument("--dft-precision", choices=["bf16x3", "highest"],
                   default="highest",
                   help="kernels' DFT products: exact FP32 ('bf16x3', the "
                        "3xTF32 tier, is not yet ported)")
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
    p.add_argument("--distributed", action="store_true", help="(not yet ported)")
    p.add_argument("--watchdog-timeout", type=float, default=0,
                   help="(not yet ported)")
    return p


def _refuse_unported(args) -> None:
    """Raise on any flag whose path this package does not have yet."""
    unported = {
        "--fov-grid": args.fov_grid is not None,
        "--fov-overlap": args.fov_overlap is not None,
        "--color-mode rgb": args.color_mode == "rgb",
        "--debug": args.debug,
        "--debug-led": args.debug_led is not None,
        "--distributed": args.distributed,
        "--watchdog-timeout": args.watchdog_timeout > 0,
        "--no-native": args.no_native,
    }
    for flag, given in unported.items():
        if given:
            raise ValueError(f"{flag} is not yet ported to fpm_torch")


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
        # Open Directory." and friends, fpmMain.cpp:266-270).
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
    if args.mesh and args.color_mode == "rgb":
        raise ValueError("--color-mode rgb does not support --mesh (the three "
                         "channels already batch in one program)")
    if args.mesh and args.fov_grid:
        raise ValueError("--fov-grid auto-shards ROIs over all devices; --mesh is "
                         "not supported with it")
    _refuse_unported(args)
    import numpy as np
    import torch

    from .config import load_config
    from .data.loader import load_dataset
    from .models.epry import effective_chunk_size, reconstruct
    from .utils.checkpoint import (
        fingerprint,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from .utils.metrics import MetricsLogger
    from .utils.outputs import save_results
    from .utils.profiling import phase, trace

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

    os.makedirs(args.output, exist_ok=True)
    logger = MetricsLogger(args.metrics_jsonl or os.path.join(args.output, "metrics.jsonl"),
                           resume=bool(args.resume))
    try:
        logger.log("config", path=os.path.abspath(args.config), iterations=cfg.iterations,
                   n_large=cfg.n_large, np_size=cfg.np_size, device=device)
        with trace(args.trace_dir):
            with phase("ingest", logger):
                dataset = load_dataset(cfg)
            logger.log("dataset", leds=int(dataset.geom.num_leds))
            print(f"[fpm-torch] loaded {dataset.geom.num_leds} LED frames "
                  f"(Np={cfg.np_size}, Nlarge={cfg.n_large})")

            # --mesh, or the config's tileGrid key, resolved before the
            # fingerprint so that provenance records what runs: a mesh run
            # always has batched (chunked-Jacobi) sweep semantics.
            mesh_req = args.mesh or (
                list(cfg.tile_grid) if tuple(cfg.tile_grid) != (1, 1) else None)
            effective_mode = "batched" if mesh_req else args.mode
            # Provenance: everything that changes the iteration trajectory,
            # with the chunk that will actually run (a pure LED mesh rounds it
            # up to a multiple of its led axis). The keys match fpm_tpu's, so
            # checkpoints carry over between the packages.
            n_led_fp = mesh_req[0] if (mesh_req and mesh_req[1] == 1) else 1
            eff_chunk = effective_chunk_size(cfg.np_size, args.chunk_size,
                                             int(dataset.geom.num_leds),
                                             bool(args.use_pallas), effective_mode,
                                             n_led=n_led_fp)
            run_fp = fingerprint(
                cfg, dataset.geom, mode=effective_mode, chunk_size=eff_chunk,
                chunk_assign=args.chunk_assign, global_max=args.global_max,
                use_pallas=bool(args.use_pallas), dft_precision=args.dft_precision,
                comm_precision=args.comm_precision,
                stale_consensus=bool(args.stale_consensus),
                mesh="x".join(map(str, mesh_req)) if mesh_req else None,
            )
            logger.log("solver_options", mode=effective_mode, chunk_size=eff_chunk,
                       chunk_assign=args.chunk_assign, global_max=args.global_max,
                       use_pallas=bool(args.use_pallas),
                       dft_precision=args.dft_precision,
                       comm_precision=args.comm_precision,
                       stale_consensus=bool(args.stale_consensus),
                       mesh=list(mesh_req) if mesh_req else None, device=device)

            initial_state, start_iter = None, 0
            if args.resume:
                ck = latest_checkpoint(args.output)
                if ck:
                    obj_f, pupil, start_iter = load_checkpoint(
                        ck, expect=run_fp, strict=not args.resume_unsafe)
                    initial_state = (obj_f, pupil)
                    print(f"[fpm-torch] resuming from {ck} (iteration {start_iter})")

            total = cfg.iterations
            if start_iter >= total:
                raise ValueError(
                    f"checkpoint is already at iteration {start_iter} >= the "
                    f"requested total {total}; nothing to resume (raise -n to "
                    "extend the run)")
            chunk = args.checkpoint_every if args.checkpoint_every > 0 else total
            solver_kwargs = dict(global_max=args.global_max, chunk_size=args.chunk_size,
                                 chunk_assign=args.chunk_assign, use_pallas=args.use_pallas,
                                 dft_precision=args.dft_precision)
            if mesh_req:
                from .parallel import (
                    make_mesh,
                    reconstruct_led_sharded,
                    reconstruct_tile_sharded,
                )

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

            result = None
            with phase("solve", logger):
                done = start_iter
                while done < total:
                    step = min(chunk, total - done)
                    result = run_chunk(step, initial_state)
                    done += step
                    initial_state = (result.obj_f_centered, result.pupil)
                    logger.log("iterations", done=done,
                               data_residual=float(result.metrics["data_residual"][-1]),
                               update_norm=float(result.metrics["update_norm"][-1]))
                    if (args.checkpoint_every > 0 and done < total
                            and (done - start_iter) % args.checkpoint_every == 0):
                        save_checkpoint(os.path.join(args.output, f"ckpt_{done}.npz"),
                                        result.obj_f_centered, result.pupil, done,
                                        meta=run_fp)
            with phase("output", logger):
                save_results(result, args.output, cfg)
    finally:
        logger.close()
    print(f"[fpm-torch] results written to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
