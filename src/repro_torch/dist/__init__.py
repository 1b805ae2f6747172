"""The distribution substrate: device meshes, shard arithmetic, placement
of host blocks for the streaming engine, and the multi-host map-reduce over
``torch.distributed``.

* ``repro_torch.dist.meshes`` — ``Mesh`` / ``make_mesh`` / ``host_mesh``:
  named device meshes, whose positions may repeat a device (several shards
  on one card); ``factor_mesh``: the 2-D grid split the §III planners share.
* ``repro_torch.dist.sharding`` — ``axes_tuple``, ``mesh_extent`` and the
  shard arithmetic the mesh engines use in place of ``shard_map``.
* ``repro_torch.dist.streaming`` — ``BlockPlacer`` / ``PrefetchPlacer`` /
  ``CrossPassReader``: streamed observation blocks onto one device or a
  mesh.
* ``repro_torch.dist.multihost`` — ``init_multihost`` (a gloo process
  group), ``HostShardSpec`` / ``resolve_host_shards`` (the §III rule applied
  to processes: each reads only its block/column ranges) and
  ``HostCollectives`` (the per-pass reduce as explicit collectives).
"""

from repro_torch.dist.meshes import Mesh, factor_mesh, host_mesh, make_mesh  # noqa: F401
from repro_torch.dist.multihost import (  # noqa: F401
    HostCollectives,
    HostShardSpec,
    init_multihost,
    resolve_host_shards,
    split_range,
)
from repro_torch.dist.sharding import axes_tuple, mesh_extent  # noqa: F401
from repro_torch.dist.streaming import BlockPlacer, PrefetchPlacer  # noqa: F401
