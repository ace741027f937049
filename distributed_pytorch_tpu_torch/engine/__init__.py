"""Serving-side decode engine: continuous batching over a paged KV cache
with radix prefix reuse (see engine/decode.py; the block allocator lives
in ops/block_pool.py). The async request scheduler + HTTP front-end above
it live in serve/."""

from distributed_pytorch_tpu_torch.engine.decode import (Admission,
                                                         DecodeEngine,
                                                         RETIRE_REASONS,
                                                         Retired, StepResult)
from distributed_pytorch_tpu_torch.ops.block_pool import NoFreeBlocks

__all__ = ["DecodeEngine", "Admission", "Retired", "StepResult",
           "RETIRE_REASONS", "NoFreeBlocks"]
