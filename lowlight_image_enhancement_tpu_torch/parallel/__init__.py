"""Parallelism of the port: data-parallel training over a
``torch.distributed`` world (one process per device), ZeRO-1, the
height-sharded spatial forward, and the in-process device mesh of serving
and export. Counterpart of ``lowlight_image_enhancement_tpu/parallel``.
"""

from lowlight_image_enhancement_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_mean_,
    create_mesh,
    put_replicated,
    replicate,
    shard_batch,
)
from lowlight_image_enhancement_tpu_torch.parallel.multihost import (  # noqa: F401
    host_info,
    init_multihost,
    local_batch_slice,
    main_process_only,
)
from lowlight_image_enhancement_tpu_torch.parallel.spatial import (  # noqa: F401
    halo_exchange_rows,
    nafnet_apply_spatial,
)
from lowlight_image_enhancement_tpu_torch.parallel.zero import (  # noqa: F401
    zero1_device_put,
    zero1_shardings,
)
