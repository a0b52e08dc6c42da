from .sharding import (
    Mesh,
    Shards,
    local_devices,
    make_mesh,
    shard_rows,
    replicate,
    local_row_count,
)
