"""The benchmark's cells on the CPU: ``BENCHMARK.json`` and its configuration
file, the cells' work counted from the shapes, the correctness check, the
breakdown's reading of a trace, and ``python -m fpm_torch.bench --cell``'s
rehearsal and its refusal without a card. The cells on the card are
chip_smoke.py's ``benchmark`` phase."""

import json
import math
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from fpm_torch import bench as tb
from fpm_torch.data.simulate import make_test_object, simulate_images
from fpm_torch.geometry import compute_geometry
from fpm_torch.models import epry
from fpm_torch.ops import kernels as tk

REPO = Path(__file__).resolve().parents[1]
CELLS = ("mono-np90-batched-c32", "mono-np90-sequential")
DOC = json.loads((REPO / "BENCHMARK.json").read_text())


def _named(cell):
    """The metrics BENCHMARK.json names for ``cell``."""
    return list(DOC["metrics"]["end_to_end"]) + [
        m for m, spec in DOC["metrics"]["per_layer"].items() if cell in spec["workloads"]]


def test_benchmark_json_has_the_two_one_card_cells_and_their_configuration():
    cells = tb.benchmark_cells()
    assert tuple(cells) == CELLS
    for name, cell in cells.items():
        assert cell["chips"] == 1
        assert (REPO / cell["config"]).is_file()
        assert cell["command"] == DOC["command"].format(name=name)
        assert cell["why"]
    batched, sequential = (cells[c]["traffic"] for c in CELLS)
    assert batched == {"mode": "batched", "chunk_size": 32, "chunk_assign": "strided",
                       "dft_precision": "bf16x3", "sweeps": 10,
                       "ladder": {"lo": 10, "hi": 210, "reps": 8}, "problems_per_launch": 1,
                       "seed": 0, "runs": 20, "warmup_runs": 1}
    assert sequential == {"mode": "sequential", "dft_precision": "bf16x3", "sweeps": 10,
                          "ladder": {"lo": 5, "hi": 55, "reps": 5}, "problems_per_launch": 1,
                          "seed": 0, "runs": 20, "warmup_runs": 1}


def test_the_metrics_carry_units_directions_bounds_and_workloads():
    e2e, layers = DOC["metrics"]["end_to_end"], DOC["metrics"]["per_layer"]
    assert {m: e2e[m]["direction"] for m in e2e} == {"led_frames_per_s": "higher",
                                                      "run_s": "lower"}
    assert e2e["led_frames_per_s"]["regression_bound"] >= 0.05
    assert e2e["run_s"]["regression_bound"] >= 0.10
    assert set(layers) == {"device_ms_per_sweep", "busy_share", "bound_share",
                           "launches_per_sweep", "ingest_s", "solve_s", "output_s", "setup_s"}
    for m, spec in layers.items():
        assert spec["workloads"] and set(spec["workloads"]) <= set(CELLS), m
    for m, spec in {**e2e, **layers}.items():
        assert spec["unit"] == tb.UNITS[m], m
    names = " ".join([*e2e, *layers]).lower()
    for absent in ("mfu", "executed_tflops", "fft_stage_efficiency"):
        assert absent not in names
    assert DOC["correct"]["rel_max_limit"] == tb.REFERENCE_LIMIT
    assert DOC["correct"]["amp_rmse_limit"] == tb.RMSE_LIMIT


def test_the_configuration_is_the_mono_dome_problem_of_bench_py():
    cfg, dataset = tb.cell_config(REPO / "benchmarks_torch" / "mono_dome_np90.json")
    geom = compute_geometry(cfg)
    b, lo = tk.bbox_extent(cfg.np_size, epry.EPRYOptions.from_config(cfg).pupil_radius)
    shapes = json.loads((REPO / "benchmarks_torch" / "mono_dome_np90.json").read_text())["shapes"]
    assert (cfg.np_size, cfg.n_large, int(geom.num_leds), b, lo) == (90, 360, 193, 64, 15)
    assert shapes == {"np_size": 90, "n_large": 360, "num_leds": 193, "bbox": 64, "bbox_lo": 15}
    assert not set(tb.CONFIG_META) & set(dataset)
    bcfg, bgeom, _, _ = tb.make_problem(0)
    assert np.array_equal(geom.led_numbers, bgeom.led_numbers)
    assert np.array_equal(geom.crop_start, bgeom.crop_start)
    assert (cfg.pixel_size, cfg.objective_mag, cfg.objective_na, cfg.wavelength,
            cfg.max_illumination_na, cfg.delta1, cfg.delta2) == (
        bcfg.pixel_size, bcfg.objective_mag, bcfg.objective_na, bcfg.wavelength,
        bcfg.max_illumination_na, bcfg.delta1, bcfg.delta2)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cells_work_is_the_hand_count_from_its_shapes(cell):
    """K = 193 LEDs, Np 90, b 64, NL 360, the same in both modes: per LED
    2·(n+b) FFTs of length n at 5·n·log2(n), 16 per image element and 54 per
    bbox element; bytes: O in and out, pupil in and out, support, the
    frames, one (y, x) start per LED, two metrics, 4 bytes each."""
    cfg, _ = tb.cell_config(REPO / tb.benchmark_cells()[cell]["config"])
    nbytes, flops = tb.cell_work(cfg, compute_geometry(cfg))
    k, n, b, nl = 193, 90, 64, 360
    assert flops == pytest.approx(
        k * (2 * (n + b) * 5 * n * math.log2(n) + 16 * n * n + 54 * b * b), rel=1e-12)
    assert nbytes == 4 * (4 * nl * nl + 4 * n * n + n * n + k * n * n + 2 * k + 2)
    assert tb.bound(nbytes, flops) == pytest.approx((0.00360, "operations"), rel=5e-3)


@pytest.mark.parametrize("mode", ("sequential", "batched"))
def test_the_correctness_check_rejects_one_perturbed_element(mode):
    """The rehearsal's problem (the cell's configuration at Np 16), 10 sweeps
    of the kernel route's plain versions against the cell's reference."""
    cfg, _ = tb.cell_config(REPO / "benchmarks_torch" / "mono_dome_np90.json", tb.REHEARSAL_NP)
    geom = compute_geometry(cfg)
    truth = make_test_object(cfg.n_large, seed=0)
    images = simulate_images(truth, geom, cfg, quantize=True)
    traffic = next(c["traffic"] for c in tb.benchmark_cells().values()
                   if c["traffic"]["mode"] == mode)
    over = {"chunk_size": 32, "chunk_assign": "strided"} if mode == "batched" else {}
    res = epry.reconstruct(images, geom, cfg, iterations=10, device="cpu", use_pallas=True,
                           mode=mode, **over)
    ref_o, ref_p, _ = tb.reference_state(images, geom, cfg, traffic)
    limit = tb.REFERENCE_LIMIT[mode]

    def verdict(spectrum, pupil):
        return tb.correctness(res.obj_crop, spectrum, pupil, truth, ref_o, ref_p, limit)

    good = verdict(res.obj_f_centered, res.pupil)
    assert good["correct"], good
    i = np.unravel_index(np.abs(ref_o).argmax(), ref_o.shape)
    bad_o = res.obj_f_centered.copy()
    bad_o[i] *= 1 + 2 * limit
    assert not verdict(bad_o, res.pupil)["correct"]
    bad_p = res.pupil.copy()
    bad_p.flat[np.abs(ref_p).argmax()] += 2 * limit * np.abs(ref_p).max()
    assert not verdict(res.obj_f_centered, bad_p)["correct"]
    nan_o = res.obj_f_centered.copy()
    nan_o[0, 0] = np.nan
    assert not verdict(nan_o, res.pupil)["correct"]


@pytest.mark.parametrize("chunk,assign", [(8, "strided"), (7, "contiguous"), (0, "strided")])
def test_the_batched_reference_is_fpm_tpus_batched_sweep(chunk, assign):
    """``bench.batched_oracle``, written apart from the solver, against
    fpm_tpu's batched mode in complex128 after 3 sweeps, within 1e-12."""
    from fpm_torch.data.simulate import synthetic_dataset
    from fpm_tpu.models.epry import reconstruct as jreconstruct

    ds = synthetic_dataset(np_size=16, grid=5, seed=1)
    ref = jreconstruct(ds.images, ds.geom, ds.cfg, iterations=3, dtype="complex128",
                       mode="batched", chunk_size=chunk, chunk_assign=assign)
    obj, pupil = tb.batched_oracle(ds.images, ds.geom, ds.cfg, 3, chunk or 25, assign)
    assert tb.rel_max(obj, np.asarray(ref.obj_f_centered)) < 1e-12
    assert tb.rel_max(pupil, np.asarray(ref.pupil)) < 1e-12


@pytest.mark.parametrize("mode", ("sequential", "batched"))
def test_the_sweep_loop_is_the_kernel_routes_and_its_one_pass_control_fails(mode):
    """The bench's sweep loop (``solver``, ``swept``) after 10 sweeps gives
    ``reconstruct``'s kernel-route state, bit for bit, and passes the cell's
    check; the same loop with the one-pass product (the control) does not."""
    cfg, _ = tb.cell_config(REPO / "benchmarks_torch" / "mono_dome_np90.json", tb.REHEARSAL_NP)
    geom = compute_geometry(cfg)
    truth = make_test_object(cfg.n_large, seed=0)
    images = simulate_images(truth, geom, cfg, quantize=True)
    traffic = next(c["traffic"] for c in tb.benchmark_cells().values()
                   if c["traffic"]["mode"] == mode)
    over = {k: traffic[k] for k in ("mode", "dft_precision", *(
        tb.BATCHED_KEYS if mode == "batched" else ()))}
    solve = tb.solver(cfg, geom, images, "cpu", **over)
    spectrum, pupil = tb.swept(solve, 10)
    res = epry.reconstruct(images, geom, cfg, iterations=10, device="cpu", use_pallas=True,
                           **over)
    np.testing.assert_array_equal(spectrum.astype(np.complex64), res.obj_f_centered)
    np.testing.assert_array_equal(pupil.astype(np.complex64), res.pupil)
    ref_o, ref_p, _ = tb.reference_state(images, geom, cfg, traffic)
    limit = tb.REFERENCE_LIMIT[mode]
    assert tb.loop_checks(spectrum, pupil, truth, ref_o, ref_p, limit)["correct"]
    control = tb.swept(solve, 10, tb.CONTROL_ABLATION)
    assert not tb.loop_checks(*control, truth, ref_o, ref_p, limit)["correct"]


def test_a_cell_refuses_more_than_one_problem_per_launch():
    traffic = dict(tb.benchmark_cells()[CELLS[1]]["traffic"], problems_per_launch=2)
    with pytest.raises(SystemExit), mock.patch.object(tb, "run_cell") as run:
        tb.main(["--config", "benchmarks_torch/mono_dome_np90.json", "--traffic",
                 json.dumps(traffic), "--device", "cpu"])
    assert not run.called
    with pytest.raises(ValueError, match="one problem per launch"):
        tb.run_cell("x", REPO / "benchmarks_torch" / "mono_dome_np90.json", traffic, "cpu")


@pytest.mark.parametrize("lo,hi,per_sweep,dropped", [(2, 5, 3, 1), (2, 12, 15, 35)])
def test_the_device_ladder_cuts_its_runs_from_the_end_past_a_dropped_record(
        tmp_path, lo, hi, per_sweep, dropped):
    """``device_ladder`` on a synthetic trace of the ladder's runs (warm lo
    and hi, then 2 × lo, 2 × hi; ``per_sweep`` device events a sweep, the
    warm runs' slower; each run ended by its marker) whose first ``dropped``
    records the profiler lost, up to more than two sweeps' worth: the
    measured runs' differential, the drop counted; a record or a marker
    dropped inside a measured run is refused."""
    names = (["void fpm::k2_rowmax_init(float*)", "void fpm::k2_sweep<1>(float*)"]
             + ["Memcpy DtoD"] * (per_sweep - 2))
    durs = [1.0, 100.0] + [0.5] * (per_sweep - 2)
    marker = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events, ts = [], 0.0
    for i, n in enumerate([lo, hi, lo, lo, hi, hi]):
        for _ in range(n):
            for name, dur in zip(names, durs):
                events.append({"ph": "X", "cat": "kernel" if "fpm" in name else "gpu_memcpy",
                               "name": name, "ts": ts, "dur": dur + (0.25 if i < 2 else 0.0)})
                ts += dur + 1
        events.append({"ph": "X", "cat": "kernel", "name": marker, "ts": ts, "dur": 2.0})
        ts += 3
    kept = events[dropped:]

    class Window:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": kept}))

    def ladder():
        with mock.patch("torch.profiler.profile", Window), \
                mock.patch.object(torch.cuda, "synchronize", lambda: None), \
                mock.patch.object(torch.cuda, "_sleep", lambda cycles: None):
            return tb.device_ladder(lambda s: s, None, lo, hi, 2, tmp_path / "trace.json")

    sweep_ms = sum(durs) / 1e3
    lost = sum(e["name"] != marker for e in events[:dropped])
    assert ladder() == {"ms": pytest.approx(sweep_ms), "per_sweep": per_sweep,
                        "events": len(kept), "lost": lost}
    first = (lo + hi) * per_sweep + 2 + 3      # inside the first measured run
    for at in (first, first + lo * per_sweep - 3):   # a record; that run's marker
        kept = events[dropped:at] + events[at + 1:]
        with pytest.raises(RuntimeError, match="not the same work|cannot be cut"):
            ladder()


def test_the_breakdown_cuts_idle_time_by_the_innermost_span():
    def x(name, cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [x("bench:run", "user_annotation", 0, 100),
              x("bench:ingest", "user_annotation", 10, 20),
              x("ingest", "user_annotation", 11, 18),              # the program's own range
              x("bench:sweep enqueue", "user_annotation", 40, 5),
              x("bench:output", "user_annotation", 70, 25),
              x("void fpm::k2_sweep<1>(float*, int)", "kernel", 42, 20),
              x("void fpm::k2_sweep<1>(float*, int)", "kernel", 62, 3),
              x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 66, 2),
              x("void at::native::roll_cuda_kernel<float>(float*)", "kernel", 200, 5)]  # after
    got = tb.breakdown(events)
    assert got["run_ms"] == pytest.approx(0.1)
    assert got["device_busy_ms"] == pytest.approx(0.025)
    assert got["idle_share"] == pytest.approx(0.75)
    assert got["top_kernels"] == [
        {"name": "fpm::k2_sweep<1>", "ms": pytest.approx(0.023), "launches": 2},
        {"name": "Memcpy DtoH", "ms": pytest.approx(0.002), "launches": 1}]
    assert got["idle_ms_by_span"] == pytest.approx(
        {"run": 0.010 + 0.010 + 0.001 + 0.002 + 0.005, "ingest": 0.020,
         "sweep enqueue": 0.002, "output": 0.025})
    assert got["host_ms_by_span"] == pytest.approx(
        {"run": 0.050, "ingest": 0.020, "sweep enqueue": 0.005, "output": 0.025})
    assert [(g["span"], g["ms"], g["at_ms"]) for g in got["idle_gaps"]] == [
        ("output", pytest.approx(0.025), pytest.approx(0.070)),
        ("ingest", pytest.approx(0.020), pytest.approx(0.010)),
        ("run", pytest.approx(0.010), pytest.approx(0.0)),
        ("run", pytest.approx(0.010), pytest.approx(0.030)),
        ("run", pytest.approx(0.005), pytest.approx(0.095))]


def _module(*args):
    return subprocess.run([sys.executable, "-m", "fpm_torch.bench", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_rehearses_on_the_cpu_with_every_metric_named_and_null(cell):
    out = _module("--cell", cell, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 2
    crumbs, line = (json.loads(s) for s in lines)
    assert line["rehearsal"] is True and line["correct"] is True and line["cell"] == cell
    for m in _named(cell):
        assert m in line and line[m] is None, m
    for m in tb.HOST_METRICS:
        assert line[f"cpu_{m}"] > 0, m
    assert line["np_size"] == tb.REHEARSAL_NP and line["num_leds"] == 193
    assert line["checks"]["amp_rmse"] < tb.RMSE_LIMIT
    assert crumbs["cell"] == cell
    spans = set(crumbs["breakdown"]["host_ms_by_span"])
    assert spans == {"run", "ingest", "init", "sweep enqueue", "final transform", "output"}


def test_a_cell_runs_by_config_and_traffic():
    line = {"correct": True, "checks": {}}
    traffic = tb.benchmark_cells()[CELLS[1]]["traffic"]
    with mock.patch.object(tb, "run_cell", return_value=(line, {})) as run:
        rc = tb.main(["--config", "benchmarks_torch/mono_dome_np90.json", "--traffic",
                      json.dumps(traffic), "--device", "cpu", "--seed", "3"])
    assert rc == 0
    assert run.call_args.args == ("mono_dome_np90-sequential",
                                  "benchmarks_torch/mono_dome_np90.json", traffic, "cpu", 3,
                                  None, None, False)
    with mock.patch.object(tb, "run_cell", return_value=(dict(line, correct=False), {})):
        assert tb.main(["--cell", CELLS[0], "--device", "cpu"]) == 1
    batched = dict(tb.benchmark_cells()[CELLS[0]]["traffic"])
    del batched["chunk_size"]
    with pytest.raises(SystemExit), mock.patch.object(tb, "run_cell") as run:
        tb.main(["--config", "benchmarks_torch/mono_dome_np90.json", "--traffic",
                 json.dumps(batched), "--device", "cpu"])
    assert not run.called


@pytest.mark.parametrize("cell", CELLS)
def test_without_a_card_a_cell_exits_1(cell):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _module("--cell", cell)
    assert out.returncode == 1 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_cell_spread_pairs_two_checkouts_and_counts_the_wins(tmp_path, capsys):
    """scripts/cell_spread.py --read DIR --other: each side's runs of a cell
    summed up apart, and the pairs this checkout won in each end-to-end
    metric's direction (a tie for neither); a control that came out correct
    fails the call."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("cell_spread", REPO / "scripts/cell_spread.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cell = "mono-np90-sequential"
    fps = {"this": [60.0, 61.0, 59.0], "other": [50.0, 61.0, 58.0]}
    run_s = {"this": [0.09, 0.10, 0.11], "other": [0.10, 0.10, 0.10]}
    for side in fps:
        (tmp_path / side).mkdir()
        for i in range(3):
            line = {m: 1.0 for m in _named(cell)}
            line.update(led_frames_per_s=fps[side][i], run_s=run_s[side][i], correct=True,
                        device="card", checks={"spectrum_rel_max": 1e-6, "pupil_rel_max": 1e-5,
                                               "sweep_loop": {"spectrum_rel_max": 2e-6,
                                                              "pupil_rel_max": 2e-5}})
            if side == "this":
                line["control"] = {"correct": i == 2, "spectrum_rel_max": 4e-4,
                                   "pupil_rel_max": 6e-3}
            (tmp_path / side / f"{cell}.{i + 1}.out").write_text("log\n" + json.dumps(line))
    rc = cs.main(["--read", str(tmp_path), "--other", "unused", "--cell", cell])
    row = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rc == 1                                  # the third control came out correct
    assert row["pairs"] == 3 and row["this_wins"] == {"led_frames_per_s": 2, "run_s": 1}
    assert row["this"]["led_frames_per_s"]["median"] == 60.0
    assert row["other"]["led_frames_per_s"]["median"] == 58.0
    assert row["this"]["control_correct"] == [False, False, True]
    assert row["this"]["rel_max"] == 2e-5 and "control_rel_max" not in row["other"]


def test_chip_smoke_runs_a_cell_again_only_after_a_lost_run_marker(capsys):
    """chip_smoke.py's benchmark phase: a cell whose device ladder's trace
    lost a run marker (bench.ladder_runs refuses it) runs once more; a
    second loss, and any other failure, is raised."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lost = RuntimeError("5 of 6 run markers in the window, 175 device events after the last: "
                        "the runs cannot be cut")

    def fake(*outcomes):
        calls = iter(outcomes)

        def run_cell(*args, **kw):
            out = next(calls)
            if isinstance(out, Exception):
                raise out
            return out
        return mock.Mock(REPO=REPO, run_cell=mock.Mock(side_effect=run_cell))

    cell = tb.benchmark_cells()[CELLS[1]]
    bench = fake(lost, ("line", "crumbs"))
    assert smoke.run_bench_cell(bench, CELLS[1], cell, "card") == ("line", "crumbs")
    assert bench.run_cell.call_count == 2
    assert json.loads(capsys.readouterr().out)["run_again"] == str(lost)
    for outcomes in ((lost, lost), (RuntimeError("a run of 12 sweeps holds 3 device events"),)):
        bench = fake(*outcomes)
        with pytest.raises(RuntimeError):
            smoke.run_bench_cell(bench, CELLS[1], cell, "card")
        assert bench.run_cell.call_count == len(outcomes)
