"""Data parallelism (`dist`), counterpart of otvm_tpu/parallel."""
from .dist import (  # noqa: F401
    all_reduce_mean,
    init_distributed,
    process_count,
    process_index,
)
