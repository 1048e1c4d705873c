"""The card cases of flash attention and the CGE bucketed passes, shared by
``chip_smoke.py`` (phase 3c) and ``tests/test_torch_kernels_cuda.py``:
each kernel is held against its plain form on these shapes at these
tolerances."""
from __future__ import annotations

import torch

# (B, H, S, T, D, Dv, input scale): the shapes of tests/test_kernels_flash.py,
# ragged S = T = 100, T = 2 S (top-left causal), inputs scaled x8 so that
# scores of order 100 push the online rescaling, a 4096-token sequence
# (64 key tiles of rescaling), D = 192 with Dv = 128 (the MLA head shape),
# D = Dv = 256 (the widest the wrapper takes: four value chunks per thread
# and 209 KB of shared memory in f32, four 64-column atoms of Q, K and V
# and 193 KB in bf16), D = 72 with Dv = 40 (multiples of 8 but not of 16:
# the bf16 kernel's zero-filled tails) over ragged S = T = 200, and S > T
# with a ragged last key tile (S = 300, T = 150)
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
    (1, 2, 200, 200, 72, 40, 1.0),
    (2, 1, 300, 150, 64, 64, 1.0),
]
# f32: 64-key tiles against the plain form's 128-key blocks, sums in
# another order. bf16: the kernel multiplies P.V on the tensor cores with
# P rounded to bf16 (8 significant bits, so at most 2^-8 relative to each
# term p v), and the output's own bf16 rounding adds at most 2^-8
# relative: together 2^-7 (7.8e-3) of sum p |v|, under rtol 1e-2 where
# the output is not a cancelling sum; atol covers outputs near zero
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=4e-3)}
# the squared norms: f32 sums of the same squares in another order
NORM_TOL = dict(rtol=1e-5, atol=0.0)
# (n_buckets, width): the sweep of tests/test_kernels_cge.py, then widths
# that are not a multiple of a 16-byte vector
CGE_SHAPES = [(1, 2048), (4, 4096), (8, 8192), (3, 6144), (5, 3001),
              (7, 2050)]
