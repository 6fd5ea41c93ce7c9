"""Matmul precision of the plain modules (magpie_tts_tpu/ops/precision.py).

The JAX package asks every matmul for float32 accumulation
(``preferred_element_type=float32``) and rounds to the compute dtype only
where its source writes ``.astype``. ``torch.matmul`` on bfloat16 tensors
returns the product already rounded to bfloat16 (and cuBLAS may reduce in
bfloat16), so the port multiplies float32 copies: a product of two bfloat16
values is exact in float32, the sum runs in float32, and each caller rounds
where the JAX source rounds. On float32 tensors ``.float()`` is a no-op.
"""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32, whatever the operands' dtype."""
    return torch.matmul(a.float(), b.float())
