from .persist import (
    VectorStore,
    StoreError,
    StoreLockedError,
    list_databases,
    delete_database,
    unlock_database,
    collection_name,
    list_aliases,
    set_alias,
    delete_alias,
    resolve_alias,
)
from .index import (BinaryIndex, DeviceIndex, HostIndex, MultiVecIndex,
                    PQIndex, SearchResult)
from .ivf import IVFIndex
from .sparse import SparseIndex
from .filter import (
    Filter,
    FilterError,
    parse_filter,
    payload_mask,
)
