"""Tensor-wise fp8 cast: CUDA C++ for Hopper (``csrc/fp8_cast.cu``), its
plain PyTorch version (``ref.py``) and the device dispatch (``ops.py``)."""
