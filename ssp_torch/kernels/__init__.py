"""Hand-written CUDA kernels (``ssp_torch/csrc``), each beside its plain
PyTorch version: ``stem`` (``stem.cu``), ``down1`` (``down1.cu``),
``nms`` (``nms.cu``) and ``vresample`` (``vresample.cu``), on which the
two-pass warp of ``warp_twopass`` is built; and two that replace no TPU
kernel, ``bfmatch`` (``bfmatch.cu``) and ``ordered_scatter``
(``ordered_scatter.cu``, the training gathers' backward in a fixed order).  Importing this package builds
nothing; a kernel is built the first time a CUDA tensor reaches its wrapper."""
