"""fp8 training kernels: CUDA C++ for Hopper (``csrc/fp8_matmul.cu``),
their plain PyTorch versions (``ref.py``) and the device dispatch
(``ops.py``)."""
