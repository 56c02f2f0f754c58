"""Hand-written CUDA kernels (``ssp_torch/csrc``), each beside its plain
PyTorch version: ``stem`` and ``down1`` (``conv_pair.cu``) and ``nms``
(``nms.cu``).  Importing this package builds nothing; a kernel is built
the first time a CUDA tensor reaches its wrapper."""
