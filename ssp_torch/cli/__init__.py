"""Command-line entry points of the port (mirrors ``ssp/cli``).

The JAX package's ``ssp/cli/__init__.py`` sets up JAX's persistent
compilation cache for its short-lived CLI processes; the port compiles
nothing per process but its CUDA kernels, which
``ssp_torch/kernels/_build.py`` builds once into ``ssp_torch/_build/``.
"""
