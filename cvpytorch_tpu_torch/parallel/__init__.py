"""Data parallelism over ``torchrun`` ranks (counterpart of
``cvpytorch_tpu/parallel``): ``parallel.dist``."""
from .dist import (  # noqa: F401
    all_reduce_sum_,
    all_reduce_with_grad,
    allgather_pickled,
    broadcast_module_,
    global_batch,
    global_sum,
    initialize_distributed,
    is_main_process,
    local_device_count,
    local_reductions,
    process_batch_slice,
    reductions_active,
)
