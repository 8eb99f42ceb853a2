from syntalker_tpu_torch.parallel.mesh import (  # noqa: F401
    MDM_TP_LAYOUT,
    Mesh,
    P,
    data_sharding,
    make_mesh,
    param_specs,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_params,
)
from syntalker_tpu_torch.parallel.multihost import init_multihost, is_primary  # noqa: F401
