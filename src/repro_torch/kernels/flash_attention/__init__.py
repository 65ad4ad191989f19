"""Flash-attention kernels: CUDA C++ for Hopper (``csrc/flash_attention.cu``),
their plain PyTorch versions (``ref.py``) and the device dispatch
(``ops.py``)."""
