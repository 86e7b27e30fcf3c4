"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel package holds ``ops.py`` (the wrapper: a CUDA tensor launches
the kernel, a CPU tensor takes the plain version) and ``ref.py`` (the
plain version).  ``build.py`` compiles ``src/repro_torch/csrc/*.cu``."""
