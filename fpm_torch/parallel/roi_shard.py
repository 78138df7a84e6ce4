"""ROI-axis parallelism for large-FOV reconstruction (SCALING.md).

The port of ``fpm_tpu.parallel.roi_shard``. Wide-field imaging is the
workload that needs many cards: the camera frame is tiled into overlapping
Np×Np ROIs (models/largefov.py) and each ROI is an *independent* FPM
reconstruction. Tiles go in rounds over the ROI ranks; the ranks that share
a card form ONE problem-axis launch per sweep (``models.epry.
reconstruct_channels``: kernel K1 or K2 with the tiles as problems), and
there are no per-sweep collectives at all.

Where the JAX package gives each device one tile per round (``lax.map``
over its local tiles, one at a time), here a card takes as many tiles per
round as fill it (:func:`roi_slots`): K2 runs one LED of a problem on a
cluster of up to 8 of the card's SMs, so one tile alone leaves most of an
H100 idle. Results do not depend on that number: each tile is bitwise the
tile solved alone by ``reconstruct``; it moves only time, and the
fault-tolerance granularity (a killed run loses at most the round in
flight).

Under ``torch.distributed`` (``parallel.multihost``) the rounds span the
processes, as ``fpm_tpu``'s ROI mesh spans the global devices: each process
solves a contiguous share of each round's tiles on its own cards (one
launch per card), the solved tiles are gathered on every process, and the
coordinator (process 0) stitches. Every process reads the tile store (so all
agree on which tiles are left to solve); only the coordinator writes it.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import FPMConfig
from ..geometry import LEDGeometry
from ..models.epry import frames_on, reconstruct_channels
from ..models.largefov import (
    LargeFOVResult,
    roi_origins,
    stitch_fields,
    tile_from_store,
    tile_to_store,
)

# The tiles a card solves per round are its SM count divided by this: 66 on
# an H100, where K2 runs them as 66 clusters of 2 blocks, all resident at
# once, its best measured tile-sweeps per ms (PERF.md §5: K2 and K1 at P =
# 16, 33, 66 and 132 problems per launch), and K1 is within 3 % of its best.
SMS_PER_TILE = 2
# A round's tiles may take at most this share of a card's free memory.
MEMORY_SHARE = 0.5


@dataclasses.dataclass(frozen=True)
class RoiMesh:
    """The ROI ranks of this process: one device per rank, a device may hold
    many ranks (those of one card solve their tiles of a round in one
    launch). ``processes`` processes own as many ranks each, and a round
    holds all of them (:attr:`size`)."""

    ranks: tuple[torch.device, ...]
    processes: int = 1
    process_index: int = 0

    @property
    def size(self) -> int:
        return len(self.ranks) * self.processes

    def share(self, tiles: list) -> list:
        """This process's contiguous share of a round's ``tiles``."""
        n = len(tiles)
        return tiles[n * self.process_index // self.processes:
                     n * (self.process_index + 1) // self.processes]

    def describe(self) -> str:
        per = {}
        for d in self.ranks:
            per[str(d)] = per.get(str(d), 0) + 1
        where = (f"{len(self.ranks)} ROI ranks on {len(per)} device"
                 f"{'s' if len(per) != 1 else ''}: "
                 + ", ".join(f"{d} ×{n}" for d, n in per.items()))
        if self.processes > 1:
            where = (f"{self.size} ROI ranks over {self.processes} processes; "
                     f"this process's {where}")
        return where


def tile_bytes(cfg: FPMConfig, num_leds: int) -> int:
    """An upper bound of the card memory one tile of a round holds: its
    float32 frames three times (the stack, the chunk-permuted copy and its
    padding) and eight spectrum-sized float32 planes (state, the kernel's
    copy and output, the init and the final transform)."""
    return 3 * num_leds * cfg.np_size ** 2 * 4 + 8 * cfg.n_large ** 2 * 4


def roi_slots(device, bytes_per_tile: int = 0) -> int:
    """Tiles ``device`` solves per round: for a card, its SM count divided
    by :data:`SMS_PER_TILE`, at most as many tiles as fit
    :data:`MEMORY_SHARE` of its free memory; one on any other device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1
    slots = torch.cuda.get_device_properties(dev).multi_processor_count // SMS_PER_TILE
    if bytes_per_tile > 0:
        free, _ = torch.cuda.mem_get_info(dev)
        slots = min(slots, int(free * MEMORY_SHARE) // bytes_per_tile)
    return max(1, slots)


def make_roi_mesh(devices=None, bytes_per_tile: int = 0) -> RoiMesh:
    """The ROI ranks. ``devices``: one device per rank, in which a device
    may appear more than once. With ``devices=None`` every visible card
    gets :func:`roi_slots` ranks, placed round-robin over the cards (so a
    short last round spreads over all of them); without a CUDA device that
    raises. Under ``torch.distributed`` ``devices`` are this process's, its
    cards by default (``multihost.local_cards``), and every process keeps as
    many ranks as the one with the fewest."""
    from .multihost import all_processes, local_cards, process_index

    if devices is not None:
        ranks = [torch.device(d) for d in devices]
        if not ranks:
            raise ValueError("an ROI mesh needs at least one rank")
    else:
        cards = local_cards()
        slots = [roi_slots(c, bytes_per_tile) for c in cards]
        ranks = [c for s in range(max(slots)) for c, n in zip(cards, slots) if s < n]
    counts = all_processes(len(ranks))
    return RoiMesh(tuple(ranks[:min(counts)]), processes=len(counts),
                   process_index=process_index())


def reconstruct_large_fov_sharded(
    full_images: np.ndarray,
    geom: LEDGeometry,
    cfg: FPMConfig,
    grid: tuple[int, int],
    mesh: RoiMesh | None = None,
    overlap: int | None = None,
    iterations: int | None = None,
    dtype=None,
    progress=None,
    tile_store=None,
    **opt_overrides,
) -> LargeFOVResult:
    """ROI-sharded large-FOV reconstruction; matches the tile-after-tile
    ``models.largefov.reconstruct_large_fov`` (same tiling, same per-ROI
    solver, same stitch).

    Tiles run in rounds of ``mesh.size``. The live tiles of a round (those
    not loaded from the store) are dealt in order over this process's share
    (:meth:`RoiMesh.share`; all of them on one process), the s-th to rank
    ``s``; those that share a device are solved by ONE
    :func:`~fpm_torch.models.epry.reconstruct_channels` call (on a card:
    one problem-axis launch sequence per sweep); the devices of a round run
    at once. Across processes the solved tiles are then gathered on every
    process, and only the coordinator stitches (``stitched`` is None on the
    others). With a ``tile_store`` every round's tiles are persisted before
    the next round starts, and stored tiles are loaded, not solved: a cached
    tile, or a padding slot of the last round, is not put into the launch at
    all. A killed run therefore loses at most the round in flight.
    ``mesh=None``: :func:`make_roi_mesh` over the visible cards.
    """
    from .multihost import all_processes

    np_sz = cfg.np_size
    rif = cfg.res_improvement_factor
    if overlap is None:
        overlap = np_sz // 4
    origins_px, stride = roi_origins(cfg, grid, overlap, full_images.shape[1:])
    if mesh is None:
        mesh = make_roi_mesh(bytes_per_tile=tile_bytes(cfg, geom.num_leds))
    cols = grid[1]
    t_real = len(origins_px)

    # A card gets the whole frames once (cut into its tiles there); the CPU
    # cuts them from the host array.
    sources = {d: frames_on(full_images, d) if d.type == "cuda" else full_images
               for d in set(mesh.ranks)}

    def solve(device, idxs):
        rois = []
        for i in idxs:
            y0, x0 = origins_px[i]
            rois.append(sources[device][:, y0:y0 + np_sz, x0:x0 + np_sz])
        return reconstruct_channels(rois, geom, cfg, iterations=iterations, dtype=dtype,
                                    device=device, **opt_overrides)

    tiles = [None] * t_real
    for lo in range(0, t_real, mesh.size):
        live = []
        for i in range(lo, min(lo + mesh.size, t_real)):
            tiles[i] = tile_from_store(tile_store, i)
            if tiles[i] is None:
                live.append(i)
        if not live:
            continue
        groups: dict[torch.device, list[int]] = {}
        for s, i in enumerate(mesh.share(live)):
            groups.setdefault(mesh.ranks[s], []).append(i)
        if len(groups) > 1:
            with ThreadPoolExecutor(len(groups)) as pool:
                solved = list(pool.map(lambda kv: solve(*kv), groups.items()))
        else:
            solved = [solve(*kv) for kv in groups.items()]
        mine = {i: res for idxs, results in zip(groups.values(), solved)
                for i, res in zip(idxs, results)}
        if mesh.processes > 1:
            mine = {i: res for part in all_processes(mine) for i, res in part.items()}
        for i in live:
            tiles[i] = mine[i]
            tile_to_store(tile_store, i, tiles[i])
            if progress is not None:
                progress(i // cols, i % cols, tiles[i])
    stitched, origins = None, None
    if mesh.process_index == 0:
        stitched, origins = stitch_fields(
            [t.obj_crop for t in tiles], grid,
            hr_size=np_sz * rif, hr_stride=stride * rif, overlap_hr=overlap * rif,
        )
    return LargeFOVResult(stitched=stitched, tiles=tiles, tile_origins=origins)
