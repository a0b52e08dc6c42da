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
from .index import DeviceIndex
