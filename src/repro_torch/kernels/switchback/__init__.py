"""SwitchBack int8 kernels: CUDA C++ for Hopper (``csrc/switchback.cu``),
their plain PyTorch versions (``ref.py``) and the device dispatch
(``ops.py``)."""
