"""Tensor ops of the port: RoPE, the paged KV block pool, the attention
dispatch and the hand-written CUDA attention kernels' wrappers."""
