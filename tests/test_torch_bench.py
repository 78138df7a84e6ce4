"""``fpm_torch.bench`` on the CPU: its problem is ``bench.py``'s bit for bit,
its accounting gives PERF.md's bounds, its ladder and guard do their
arithmetic, its baseline is cached under ``build/``, and its entry point
rehearses on the CPU and refuses to measure without a card. The card runs
of the bench are chip_smoke.py's ``bench`` phase."""

import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from fpm_torch import bench as tb
from fpm_torch.models import epry
from fpm_torch.ops import kernels as tk

REPO = Path(__file__).resolve().parents[1]
DEVICE_METRICS = ("value", "vs_baseline", "seconds_per_iteration", "device_ms_per_sweep",
                  "busy_share", "bound_ms", "bound_share", "executed_tflops",
                  "fft_stage_efficiency")


def test_make_problem_is_bench_pys_bit_for_bit():
    sys.path.insert(0, str(REPO))
    try:
        import bench as jbench
    finally:
        sys.path.remove(str(REPO))
    jcfg, jgeom, jimages = jbench.make_problem()
    cfg, geom, images, _ = tb.make_problem(0)
    assert (cfg.np_size, cfg.n_large, int(geom.num_leds)) == (90, 360, 193)
    assert (cfg.np_size, cfg.n_large) == (jcfg.np_size, jcfg.n_large)
    assert np.array_equal(geom.led_numbers, jgeom.led_numbers)
    assert images.dtype == jimages.dtype and np.array_equal(images, jimages)


def _k3_mono():
    """K3's bound inputs as rank (0,0) of mesh (4,1) on the mono problem."""
    from fpm_torch.parallel import led_shard, make_mesh

    cfg, geom, images, _ = tb.make_problem(0)
    b, lo = tk.bbox_extent(90, epry.EPRYOptions.from_config(cfg).pupil_radius)
    route, _ = led_shard.prepare_led_sharded(images, geom, cfg,
                                             make_mesh(4, 1, devices=["cpu"] * 4),
                                             use_pallas=True, chunk_size=32)
    _, _, r_starts, r_valid, _ = (g[0][0] for g in route.inputs)
    valid = r_valid[0].tolist()
    o_elems = tb.window_union(r_starts[0].view(-1, 2).tolist(), valid, 90, b, lo, 360, 360)
    return tb.increments_work(sum(valid), len(valid), 90, b, 360, 360, o_elems)


def _k3_dog():
    """K3's bound inputs as rank (0,0) of mesh (2,2) on the dogStomach
    problem: tile 0's halo block, its workset of chunk 0 at chunk 16."""
    from fpm_torch.parallel import tile_shard

    cfg, geom, images, _ = tb.make_problem(0, **tb.DOG_OPTICS)
    n, nl = cfg.np_size, cfg.n_large
    b, lo = tk.bbox_extent(n, epry.EPRYOptions.from_config(cfg).pupil_radius)
    _, starts = epry._sorted_device_inputs(images, geom, torch.complex64, "cpu")
    idx, tile_s = tile_shard.partition_leds_by_tile(geom, nl, 2, 2, n, chunk_size=16)
    sel = torch.as_tensor(idx[0, 0, 0])
    live = sel >= 0
    rel_starts = (starts[sel.clamp(min=0)] * live[:, None]).tolist()
    o_elems = tb.window_union(rel_starts, live.tolist(), n, b, lo, tile_s + n, nl)
    return tb.increments_work(int(live.sum()), int(live.numel()), n, b, tile_s + n, nl, o_elems)


def _sweep(optics, chunk):
    cfg, geom, _, _ = tb.make_problem(0, **optics)
    n, nl, k = cfg.np_size, cfg.n_large, int(geom.num_leds)
    b, _ = tk.bbox_extent(n, epry.EPRYOptions.from_config(cfg).pupil_radius)
    if chunk:
        return tb.sweep_work(k, n, b, nl, epry.chunk_schedule(k, chunk, "strided")[0].size,
                             has_valid=True)
    return tb.sweep_work(k, n, b, nl, k, has_valid=False)


@pytest.mark.parametrize("case,work,ms,by", [
    ("K1 mono, chunk 32", lambda: _sweep({}, 32), 0.00360, "operations"),
    ("K2 mono", lambda: _sweep({}, 0), 0.00360, "operations"),
    ("K1 dogStomach, chunk 16", lambda: _sweep(tb.DOG_OPTICS, 16), 0.00800, "operations"),
    ("K2 dogStomach", lambda: _sweep(tb.DOG_OPTICS, 0), 0.00800, "operations"),
    ("K3 mono, rank of mesh (4,1)", _k3_mono, 0.000460, "bytes"),
    ("K3 dogStomach, rank of mesh (2,2)", _k3_dog, 0.00144, "bytes"),
])
def test_the_accounting_gives_perf_mds_bounds(case, work, ms, by):
    """PERF.md §6's bound column (three significant digits)."""
    got_ms, got_by = tb.bound(*work())
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=5e-3)


def test_executed_products_count_whole_tiles():
    """Where every extent is a multiple of the tile, the tensor cores run the
    dense complex products at 3 passes: 3 × 8 real FLOPs per complex
    multiply-add; padding only adds (mono, Np 90, b 64, cluster of 4)."""
    n, b = 96, 64
    dense = 8 * (n * b * b + n * b * n + b * n * n + b * n * b)
    assert tb.executed_mma_flops(n, b, 1) == 3 * dense
    assert tb.executed_mma_flops(n, b, 2) == 3 * dense        # 48-row slabs: whole tiles
    mono = 8 * (90 * 64 * 64 * 2 + 90 * 90 * 64 * 2)
    assert 3 * mono < tb.executed_mma_flops(90, 64, 4) < 4 * 3 * mono


def test_the_ladder_and_its_guard():
    calls = []

    def run(n):             # 0.05 s of fixed costs and 2 ms a sweep
        calls.append(n)
        return 0.05 + 0.002 * n
    sec, info = tb.ladder(run, 10, 210, 3, log=lambda m: None)
    assert sec == pytest.approx(0.002) and not info["degenerate"]
    assert calls == [10, 210] + [10] * 3 + [210] * 3

    times = iter([1.0, 1.0] + [0.9] * 2 + [0.5] * 2 + [0.3] * 2 + [0.8] * 2)
    msgs = []
    sec, info = tb.ladder(lambda n: next(times), 10, 30, 2, log=msgs.append)
    assert not info["degenerate"] and sec == pytest.approx((0.8 - 0.3) / 20)
    assert len(msgs) == 1 and "degenerate" in msgs[0]        # measured again once

    msgs = []
    sec, info = tb.ladder(lambda n: 1.0 if n == 10 else 0.6, 10, 30, 2, log=msgs.append)
    assert info["degenerate"] and sec == pytest.approx(0.6 / 30)   # t_hi / hi, flagged
    assert len(msgs) == 3 and "upper bound" in msgs[-1]


def test_the_oracle_baseline_is_computed_once_and_cached_under_build(tmp_path):
    from fpm_torch.data.simulate import synthetic_dataset

    ds = synthetic_dataset(np_size=16, grid=5, seed=0)
    cache = tmp_path / "build" / "bench_baseline.json"
    with mock.patch("fpm_torch.oracle.run_fpm_oracle") as oracle:
        first = tb.oracle_baseline(ds.cfg, ds.geom, ds.images, cache=cache)
        again = tb.oracle_baseline(ds.cfg, ds.geom, ds.images, cache=cache)
    assert oracle.call_count == 1 and first == again
    assert first["num_leds"] == int(ds.geom.num_leds) and first["led_frames_per_s"] > 0
    assert json.loads(cache.read_text())
    assert tb.BASELINE_CACHE.parent == REPO / "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def _module(*args):
    return subprocess.run([sys.executable, "-m", "fpm_torch.bench", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_the_cpu_rehearsal_prints_one_line_and_no_device_metric():
    out = _module("--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["rehearsal"] is True and line["device"] == "cpu"
    assert line["cpu_seconds_per_iteration"] > 0 and line["cpu_led_frames_per_s"] > 0
    assert not [k for k in DEVICE_METRICS if k in line]


def test_without_a_card_the_bench_exits_1():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _module()
    assert out.returncode == 1 and out.stdout == ""
    assert "no CUDA device" in out.stderr
