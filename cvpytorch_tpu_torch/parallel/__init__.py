"""Parallelism over ``torchrun`` ranks (counterpart of
``cvpytorch_tpu/parallel``): ``parallel.dist`` (process groups, the data
axis's reductions), ``parallel.mesh`` (the ``(data, model, spatial)``
mesh and the tensor-parallel layout), ``parallel.tensor`` (the
column-parallel layers and the model axis's collectives) and
``parallel.spatial`` (overlap-tile evaluation)."""
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
