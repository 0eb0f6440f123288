"""The port's kernels: CUDA C++ sources (``csrc/``), their plain PyTorch
versions (``ref``), the device dispatch (``ops``) and the builder
(``build``)."""
