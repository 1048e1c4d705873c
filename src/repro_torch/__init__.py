"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Subpackages mirror ``repro`` one to one (``repro_torch.X.Y`` is the
counterpart of ``repro.X.Y``). The package imports ``torch`` and
``numpy`` only; its kernels (the aggregation kernels and the paged
flash-decode) are CUDA C++ under ``kernels/csrc`` built at first use
(``kernels/_build.py``).
"""
