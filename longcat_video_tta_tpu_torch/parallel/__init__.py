"""Multi-rank parallelism over ``torch.distributed`` (counterpart of
``longcat_video_tta_tpu/parallel``): the (data, context, tensor) mesh,
its collectives, ring context-parallel attention and Megatron-style
tensor parallelism."""

from .context_attention import (  # noqa: F401
    cp_self_attention,
    ring_self_attention,
)
from .mesh import (  # noqa: F401
    AXES,
    Mesh,
    build_mesh,
    factorize_devices,
    init_distributed,
    single_device_mesh,
)
