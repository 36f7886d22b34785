"""Hand-written Hopper kernels and their plain PyTorch versions
(counterpart of ``repro/kernels``).  Sources live in ``repro_torch/csrc``;
``kernels/_build.py`` compiles them on first use."""
