"""The card cases of flash attention and the CGE bucketed passes, shared by
``chip_smoke.py`` (phase 3c) and ``tests/test_torch_kernels_cuda.py``:
each kernel is held against its plain form on these shapes at these
tolerances."""
from __future__ import annotations

import torch

# (B, H, S, T, D, Dv, input scale): the shapes of tests/test_kernels_flash.py,
# ragged S = T = 100, T = 2 S (top-left causal), inputs scaled x8 so that
# scores of order 100 push the online rescaling, a 4096-token sequence
# (64 key tiles of rescaling), D = 192 with Dv = 128 (the MLA head shape)
# and D = Dv = 256 (the widest the wrapper takes, four value chunks per
# thread and 209 KB of shared memory)
FLASH_CASES = [
    (1, 1, 128, 128, 64, 64, 1.0),
    (2, 2, 256, 256, 64, 64, 1.0),
    (1, 2, 256, 256, 128, 128, 1.0),
    (2, 1, 512, 512, 64, 64, 1.0),
    (1, 1, 256, 256, 128, 64, 1.0),
    (1, 2, 100, 100, 64, 64, 1.0),
    (1, 2, 128, 256, 64, 32, 1.0),
    (2, 2, 256, 256, 64, 64, 8.0),
    (1, 2, 4096, 4096, 64, 64, 1.0),
    (1, 2, 256, 256, 192, 128, 1.0),
    (1, 1, 128, 128, 256, 256, 1.0),
]
# f32: 64-key tiles against the plain form's 128-key blocks, sums in
# another order; bf16: both sides compute in f32 and round the output once,
# so they differ by at most one bf16 step, 2^-7 of the value or less
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=4e-3)}
# the squared norms: f32 sums of the same squares in another order
NORM_TOL = dict(rtol=1e-5, atol=0.0)
# (n_buckets, width): the sweep of tests/test_kernels_cge.py, then widths
# that are not a multiple of a 16-byte vector
CGE_SHAPES = [(1, 2048), (4, 4096), (8, 8192), (3, 6144), (5, 3001),
              (7, 2050)]
