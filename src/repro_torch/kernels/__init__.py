"""The port's hand-written CUDA kernels (``csrc/``), their plain PyTorch
versions (``ref``), the nvcc build (``build``) and the one dispatch point
(``ops``)."""
