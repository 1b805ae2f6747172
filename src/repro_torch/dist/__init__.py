"""Placement of host blocks on the device for the streaming engine, and the
multi-host map-reduce over ``torch.distributed``.

* ``repro_torch.dist.streaming`` — ``BlockPlacer`` / ``PrefetchPlacer`` /
  ``CrossPassReader``: streamed observation blocks onto one device.
* ``repro_torch.dist.meshes`` — ``factor_mesh``: the 2-D grid split the
  §III planners share.
* ``repro_torch.dist.multihost`` — ``init_multihost`` (a gloo process
  group), ``HostShardSpec`` / ``resolve_host_shards`` (the §III rule applied
  to processes: each reads only its block/column ranges) and
  ``HostCollectives`` (the per-pass reduce as explicit collectives).
"""

from repro_torch.dist.meshes import factor_mesh  # noqa: F401
from repro_torch.dist.multihost import (  # noqa: F401
    HostCollectives,
    HostShardSpec,
    init_multihost,
    resolve_host_shards,
    split_range,
)
