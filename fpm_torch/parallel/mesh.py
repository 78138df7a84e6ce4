"""The (led, tile) mesh of ranks and its collectives.

Axes (as in ``fpm_tpu.parallel.mesh``):

* ``led``  — LED-batch data parallelism: the ranks of one ``led`` group split
  a chunk's LEDs and hold the same spectrum (block).
* ``tile`` — spectrum-row tiling: the ranks of one ``tile`` group hold
  consecutive row blocks of the spectrum and exchange halos.

A rank is a position ``(li, ti)`` of the grid with a ``torch.device``;
**several ranks may name the same device** (on a one-GPU machine they all
share it, on the CPU the tests use ``devices=["cpu"] * n``). This is the
counterpart of a JAX mesh over virtual host devices: each rank has its own
state and its own contribution, only the transport differs. Per-rank values
travel as a *grid*: a list of lists ``g[li][ti]``.

One process drives its ranks. On one process (the default) it drives them
all. Under ``torch.distributed`` (``parallel.multihost``) each process owns an
equal, contiguous share of the ranks in grid order, as ``fpm_tpu``'s
``global_mesh`` lays out ``jax.devices()`` process by process: the other
processes' ranks have no device here (``None``), :meth:`Mesh.grid` and
:meth:`Mesh.map` run the local ranks only and leave the others ``None``, and
every process runs the same program on its own ranks.

The collectives — :meth:`Mesh.psum`, :meth:`Mesh.pmax`,
:meth:`Mesh.ppermute` — are plain functions over a grid. A reduction combines
its group's payloads **in rank order** on one device and copies the result to
every member, so a result never depends on timing or on the process layout:
across processes every member's payload (cast to the wire dtype, if one is
given) is first gathered from every process, and the adds are the same adds
in the same order, so the result is bitwise that of the one-process mesh.
Each call is counted on the mesh (``mesh.counts``: calls and payload bytes,
one rank's payload per call, keyed by ``(op, axis)``), the same counts on
every process, to be held against the analytic model of ``parallel.comm``.
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
    """A grid of n-tuples as n grids (a rank of another process, ``None``,
    stays ``None`` in each)."""
    return tuple([[None if cell is None else cell[i] for cell in row] for row in grid]
                 for i in range(n))


class Mesh:
    """An ``led × tile`` grid of ranks; ``devices[li][ti]`` is a rank's
    device, ``None`` for a rank of another process. ``transport`` carries the
    collectives between processes (``parallel.multihost.ProcessTransport``);
    ``None`` on one process."""

    def __init__(self, devices, transport=None):
        self.devices = [[None if d is None else torch.device(d) for d in row]
                        for row in devices]
        self.shape = {"led": len(self.devices), "tile": len(self.devices[0])}
        self.transport = transport
        self.local_ranks = [(li, ti) for li, row in enumerate(self.devices)
                            for ti, d in enumerate(row) if d is not None]
        self.counts: dict[tuple[str, str], dict[str, int]] = {}

    @property
    def size(self) -> int:
        return self.shape["led"] * self.shape["tile"]

    @property
    def home(self) -> torch.device:
        """The device of this process's first rank."""
        li, ti = self.local_ranks[0]
        return self.devices[li][ti]

    def local(self, grid):
        """The value of this process's first rank in ``grid`` (for values
        every rank holds alike, such as a reduction's result)."""
        li, ti = self.local_ranks[0]
        return grid[li][ti]

    def describe(self) -> str:
        """``led=L tile=T (N ranks on D devices: ...)`` for the CLI's line;
        across processes also the process layout and the transport."""
        distinct = list(dict.fromkeys(str(self.devices[li][ti]) for li, ti in self.local_ranks))
        n_local = len(self.local_ranks)
        shared = "; ranks share a device" if len(distinct) < n_local else ""
        where = (f"{n_local} rank{'s' if n_local != 1 else ''} on {len(distinct)} device"
                 f"{'s' if len(distinct) != 1 else ''}: {', '.join(distinct)}{shared}")
        if self.transport is not None:
            where = f"{self.transport.describe()}; this process's {where}"
        return f"led={self.shape['led']} tile={self.shape['tile']} ({where})"

    # ------------------------------------------------------------- grids

    def grid(self, fn):
        """The grid ``fn(li, ti)`` over the local ranks (``None`` elsewhere)."""
        return [[fn(li, ti) if d is not None else None for ti, d in enumerate(row)]
                for li, row in enumerate(self.devices)]

    def map(self, fn, *grids):
        """The grid ``fn(*values of rank)`` over the local ranks of ``grids``."""
        return self.grid(lambda li, ti: fn(*(g[li][ti] for g in grids)))

    def replicate(self, t: torch.Tensor):
        """``t`` on every local rank's device (ranks on one device share one
        tensor: a rank's state is never updated in place)."""
        return self.grid(lambda li, ti: t.to(self.devices[li][ti]))

    def gather(self, grid):
        """Every rank's value of ``grid`` on :attr:`home`, on every process
        (uncounted: for results, not for the sweep's collectives)."""
        if self.transport is None:
            return [[t.to(self.home) for t in row] for row in grid]
        values = self.transport.all_gather(self, {r: grid[r[0]][r[1]] for r in self.local_ranks})
        return [[values[(li, ti)].to(self.home) for ti in range(self.shape["tile"])]
                for li in range(self.shape["led"])]

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
        full_dtype = self.local(grid).dtype
        # The payloads on the wire; accumulated in full precision below.
        wire = {(li, ti): grid[li][ti] if wire_dtype is None else grid[li][ti].to(wire_dtype)
                for li, ti in self.local_ranks}
        values = wire if self.transport is None else self.transport.all_gather(self, wire)
        out = self.grid(lambda li, ti: None)
        for group in groups:
            mine = [r for r in group if r in wire]
            if not mine:
                continue
            first = self.devices[group[0][0]][group[0][1]]
            home = first if first is not None else self.home
            acc = None
            for r in group:
                x = values[r].to(home).to(full_dtype)
                acc = x if acc is None else combine(acc, x)
            for li, ti in mine:
                out[li][ti] = acc.to(self.devices[li][ti])
        self._count(op, axes, wire[self.local_ranks[0]])
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
        permutation of the axis. Between processes the value is sent."""
        size = self.shape[axis]
        if sorted(s for s, _ in perm) != list(range(size)) or \
                sorted(d for _, d in perm) != list(range(size)):
            raise ValueError(f"perm {perm} is not a permutation of the {size}-rank "
                             f"{axis!r} axis")
        src_of = {d: s for s, d in perm}

        def src(li, ti):
            return (src_of[li], ti) if axis == "led" else (li, src_of[ti])

        self._count("ppermute", (axis,), self.local(grid))
        if self.transport is None:
            return self.grid(lambda li, ti: grid[src(li, ti)[0]][src(li, ti)[1]]
                             .to(self.devices[li][ti]))
        pairs = [(src(li, ti), (li, ti)) for li in range(self.shape["led"])
                 for ti in range(self.shape["tile"])]
        received = self.transport.exchange(self, grid, pairs)
        return self.grid(lambda li, ti: received[(li, ti)].to(self.devices[li][ti]))


def make_mesh(led: int | None = None, tile: int = 1, devices=None) -> Mesh:
    """Build an ``led × tile`` mesh of ranks.

    ``devices`` is a list of devices, one per rank, in which a device may
    appear more than once; it is checked like ``fpm_tpu.parallel.make_mesh``
    checks its device list (``led`` defaults to ``len(devices) // tile``; a
    mesh larger than the list is an error). With ``devices=None`` the ranks
    are placed round-robin over the visible CUDA devices — on a one-GPU
    machine all ranks share it — and without a CUDA device that raises.

    Under ``torch.distributed`` the mesh spans the processes
    (``parallel.multihost.process_mesh``): each process owns ``led·tile /
    processes`` ranks, and ``devices`` lists this process's devices.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from .multihost import process_mesh

        return process_mesh(led, tile, devices)
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
