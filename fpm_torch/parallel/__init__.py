"""Multi-rank reconstruction on an (led, tile) mesh: LED-batch sharding and
spectrum-tile sharding with halo exchange; and the ROI ranks of the
large-FOV mode (the port of ``fpm_tpu.parallel``). One process drives every
rank, or, under ``torch.distributed`` (``multihost.py``), each process its
equal share of them; ranks may share a device (``mesh.py``,
``roi_shard.py``). Where every rank of a process is a CUDA rank and the
processes, if several, exchange over NCCL, a sharded run captures one sweep
into a CUDA graph on each process and replays it (``graph.py``); on the
CPU and over gloo the host walks the loop."""

from .comm import (
    card_edges,
    consensus_schedule_check,
    counted_mismatches,
    led_shard_comm,
    ordered_before,
    project_weak_scaling,
    tile_shard_comm,
)
from .led_shard import prepare_led_sharded, reconstruct_led_sharded
from .mesh import Mesh, make_mesh, mesh_shape_for, peer_route
from .roi_shard import RoiMesh, make_roi_mesh, reconstruct_large_fov_sharded
from .tile_shard import (
    partition_leds_by_tile,
    prepare_tile_sharded,
    reconstruct_tile_sharded,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape_for",
    "reconstruct_led_sharded",
    "reconstruct_tile_sharded",
    "partition_leds_by_tile",
    "prepare_led_sharded",
    "prepare_tile_sharded",
    "led_shard_comm",
    "tile_shard_comm",
    "project_weak_scaling",
    "counted_mismatches",
    "consensus_schedule_check",
    "card_edges",
    "ordered_before",
    "peer_route",
    "RoiMesh",
    "make_roi_mesh",
    "reconstruct_large_fov_sharded",
]
