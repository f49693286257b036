from .sharding import (  # noqa: F401
    Mesh, ShardedBootstrapper, ShardedCiphertext, ShardedEvaluator,
    ccmm_col_to_diag_sharded, ct_sharding, gather, make_mesh, replicated,
    shard_ciphertext)
