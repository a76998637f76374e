"""The device mesh of the port: the counterpart of ``tfidf_tpu.parallel``
(``mesh``, ``sharded``, ``mesh_index``, ``mesh_ell``, ``mesh_ell_index``,
``mesh_dense``), with ``collectives`` in the place of ``shard_map``."""

from tfidf_tpu_torch.parallel.mesh import make_mesh, default_mesh_shape
from tfidf_tpu_torch.parallel.sharded import (
    ShardedArrays,
    build_sharded_arrays,
    build_ingest_batch,
    make_sharded_search,
    make_sharded_ingest,
    global_stats,
)

__all__ = [
    "make_mesh",
    "default_mesh_shape",
    "ShardedArrays",
    "build_sharded_arrays",
    "build_ingest_batch",
    "make_sharded_search",
    "make_sharded_ingest",
    "global_stats",
]
