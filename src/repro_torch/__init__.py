"""PyTorch/CUDA port of the ``repro`` package (JAX on a TPU), one slice at
a time. Same module layout: ``repro.X.Y`` pairs with ``repro_torch.X.Y``.
The port imports ``torch``, numpy and the standard library only."""
