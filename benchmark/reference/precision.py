"""The products of the plain reference, in float32 or in emulated TF32.

Every matrix product, einsum and convolution of the reference goes through
a :class:`Products`.  In float32 it is the plain operation, with TF32 off.
With ``tf32=True`` it rounds each operand to TF32 (10 explicit mantissa
bits, round to nearest even) and accumulates in float32, as the tensor
cores do in a forward product: that is the benchmark's control, the
nearest precision below the float32 that the configurations state, and
it rounds the same on the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, nearest even."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, got {x.dtype}")
    i = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    r = ((i + 0xFFF + lsb) & ~0x1FFF)
    finite = torch.isfinite(x)
    r = torch.where(finite, r, i)
    r = torch.where(r > 0x7FFFFFFF, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32).view(x.shape)


class Products:
    """Matrix products of the reference at one precision."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        """The operand as the product reads it.  Under autograd the
        rounding passes the gradient straight through, so in TF32 the
        forward products round and the backward's stay float32."""
        if not self.tf32:
            return x
        if x.requires_grad:
            return x + (round_tf32(x.detach()) - x.detach())
        return round_tf32(x)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self._r(x) for x in ops))

    def conv2d(self, x: torch.Tensor, w: torch.Tensor,
               groups: int) -> torch.Tensor:
        return F.conv2d(self._r(x), self._r(w), groups=groups)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        return self._r(x) @ self._r(w).T + b
