"""The (led, tile) mesh of ranks and its collectives, single-controller.

Axes (as in ``fpm_tpu.parallel.mesh``):

* ``led``  — LED-batch data parallelism: the ranks of one ``led`` group split
  a chunk's LEDs and hold the same spectrum (block).
* ``tile`` — spectrum-row tiling: the ranks of one ``tile`` group hold
  consecutive row blocks of the spectrum and exchange halos.

One process drives every rank. A rank is a position ``(li, ti)`` of the grid
with a ``torch.device``; **several ranks may name the same device** (on a
one-GPU machine they all share it, on the CPU the tests use
``devices=["cpu"] * n``). This is the counterpart of a JAX mesh over virtual
host devices: each rank has its own state and its own contribution, only the
transport differs. Per-rank values travel as a *grid*: a list of lists
``g[li][ti]``.

The collectives — :meth:`Mesh.psum`, :meth:`Mesh.pmax`,
:meth:`Mesh.ppermute` — are plain functions over a grid. A reduction gathers
its group's tensors on the group's first device, combines them **in rank
order**, and copies the result back to every member, so a result never
depends on timing. Each call is counted on the mesh (``mesh.counts``: calls
and payload bytes, one rank's payload per call, keyed by ``(op, axis)``), to
be held against the analytic model of ``parallel.comm``.
"""

from __future__ import annotations

import torch

from ..models.epry import resolve_device

AXES = ("led", "tile")


def mesh_shape_for(n_devices: int, n_large: int, np_size: int) -> tuple[int, int]:
    """Pick an (led, tile) factorization of ``n_devices``.

    The tile axis is capped so each row shard keeps at least ``np_size`` rows
    (patches then straddle at most two shards — single-hop halos); remaining
    devices go to the LED axis.
    """
    max_tile = max(1, n_large // np_size)
    tile = 1
    for cand in range(min(n_devices, max_tile), 0, -1):
        if n_devices % cand == 0:
            tile = cand
            break
    return n_devices // tile, tile


def unzip(grid, n: int):
    """A grid of n-tuples as n grids."""
    return tuple([[cell[i] for cell in row] for row in grid] for i in range(n))


class Mesh:
    """An ``led × tile`` grid of ranks; ``devices[li][ti]`` is a rank's device."""

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"led": len(self.devices), "tile": len(self.devices[0])}
        self.counts: dict[tuple[str, str], dict[str, int]] = {}

    @property
    def size(self) -> int:
        return self.shape["led"] * self.shape["tile"]

    def describe(self) -> str:
        """``led=L tile=T (N ranks on D devices: ...)`` for the CLI's line."""
        distinct = list(dict.fromkeys(str(d) for row in self.devices for d in row))
        shared = "; ranks share a device" if len(distinct) < self.size else ""
        return (f"led={self.shape['led']} tile={self.shape['tile']} ({self.size} ranks on "
                f"{len(distinct)} device{'s' if len(distinct) != 1 else ''}: "
                f"{', '.join(distinct)}{shared})")

    # ------------------------------------------------------------- grids

    def grid(self, fn):
        """The grid ``fn(li, ti)``."""
        return [[fn(li, ti) for ti in range(self.shape["tile"])]
                for li in range(self.shape["led"])]

    def map(self, fn, *grids):
        """The grid ``fn(*values of rank)`` over the ranks of ``grids``."""
        return self.grid(lambda li, ti: fn(*(g[li][ti] for g in grids)))

    def replicate(self, t: torch.Tensor):
        """``t`` on every rank's device (ranks on one device share one
        tensor: a rank's state is never updated in place)."""
        return self.grid(lambda li, ti: t.to(self.devices[li][ti]))

    # ------------------------------------------------------- collectives

    def reset_counts(self) -> None:
        self.counts = {}

    def _count(self, op: str, axes, payload: torch.Tensor) -> None:
        slot = self.counts.setdefault((op, ",".join(axes)), {"calls": 0, "payload_bytes": 0})
        slot["calls"] += 1
        slot["payload_bytes"] += payload.numel() * payload.element_size()

    def _groups(self, axes):
        """The rank groups a reduction over ``axes`` combines, in rank order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes or any(a not in AXES for a in axes):
            raise ValueError(f"mesh axes are {AXES}, got {axes!r}")
        n_led, n_tile = self.shape["led"], self.shape["tile"]
        if set(axes) == set(AXES):
            return AXES, [[(li, ti) for li in range(n_led) for ti in range(n_tile)]]
        if axes == ("led",):
            return axes, [[(li, ti) for li in range(n_led)] for ti in range(n_tile)]
        return axes, [[(li, ti) for ti in range(n_tile)] for li in range(n_led)]

    def _reduce(self, op: str, grid, axes, combine, wire_dtype=None):
        axes, groups = self._groups(axes)
        out = self.grid(lambda li, ti: None)
        for group in groups:
            home = self.devices[group[0][0]][group[0][1]]
            acc = None
            for li, ti in group:
                x = grid[li][ti]
                if wire_dtype is not None:        # the payload on the wire
                    x = x.to(wire_dtype)
                payload = x
                x = x.to(home)
                if wire_dtype is not None:        # accumulated in full precision
                    x = x.to(grid[li][ti].dtype)
                acc = x if acc is None else combine(acc, x)
            for li, ti in group:
                out[li][ti] = acc.to(self.devices[li][ti])
        self._count(op, axes, payload)
        return out

    def psum(self, grid, axes, wire_dtype=None):
        """All-reduce sum over ``axes`` (``"led"``, ``"tile"`` or both).
        ``wire_dtype`` casts each rank's payload (real tensors only) before it
        travels; the sum is accumulated in the dtype the tensors came in."""
        return self._reduce("psum", grid, axes, torch.add, wire_dtype)

    def pmax(self, grid, axes):
        """All-reduce max over ``axes``."""
        return self._reduce("pmax", grid, axes, torch.maximum)

    def ppermute(self, grid, axis: str, perm):
        """Point-to-point along ``axis``: position ``dst`` receives position
        ``src``'s value for each ``(src, dst)`` of ``perm``, which must be a
        permutation of the axis."""
        size = self.shape[axis]
        if sorted(s for s, _ in perm) != list(range(size)) or \
                sorted(d for _, d in perm) != list(range(size)):
            raise ValueError(f"perm {perm} is not a permutation of the {size}-rank "
                             f"{axis!r} axis")
        src_of = {d: s for s, d in perm}

        def recv(li, ti):
            src = (src_of[li], ti) if axis == "led" else (li, src_of[ti])
            return grid[src[0]][src[1]].to(self.devices[li][ti])

        self._count("ppermute", (axis,), grid[0][0])
        return self.grid(recv)


def make_mesh(led: int | None = None, tile: int = 1, devices=None) -> Mesh:
    """Build an ``led × tile`` mesh of ranks.

    ``devices`` is a list of devices, one per rank, in which a device may
    appear more than once; it is checked like ``fpm_tpu.parallel.make_mesh``
    checks its device list (``led`` defaults to ``len(devices) // tile``; a
    mesh larger than the list is an error). With ``devices=None`` the ranks
    are placed round-robin over the visible CUDA devices — on a one-GPU
    machine all ranks share it — and without a CUDA device that raises.
    """
    round_robin = devices is None
    if round_robin:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if led is None:
        led = n // tile if tile > 0 else 0
    if led < 1 or tile < 1:
        raise ValueError(f"mesh axes must be >= 1, got led={led} tile={tile} "
                         f"({n} devices available)")
    if round_robin:
        devices = [devices[i % n] for i in range(led * tile)]
    elif led * tile > n:
        raise ValueError(f"mesh led={led} x tile={tile} needs {led * tile} devices; "
                         f"only {n} available")
    return Mesh([devices[li * tile:(li + 1) * tile] for li in range(led)])
