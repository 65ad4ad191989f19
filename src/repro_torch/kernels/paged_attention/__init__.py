"""Paged-attention kernels (block-pool KV cache): CUDA C++ for Hopper
(``csrc/paged_attention.cu``), their plain PyTorch versions (``ref.py``)
and the device dispatch (``ops.py``)."""
