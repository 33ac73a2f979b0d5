"""The control of the check: the reference computed in the next precision
below the configuration's f32, bfloat16.

``bf16()`` is a ``TorchDispatchMode`` under which every operator's f32
result is rounded to bfloat16 (8 bits of mantissa) as it is produced and
kept in f32 storage, so each step of the reference computes in bfloat16
arithmetic, the step a later change could take for speed. Integer and u8
results are left alone. The check must read it as not correct."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map


class _Bf16(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False):
            return out  # shares storage that was rounded when written

        def rnd(t):
            # In place, so that an operator that wrote into its input
            # leaves the rounded value there too.
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                t.copy_(t.to(torch.bfloat16))
            return t

        return tree_map(rnd, out)


def bf16():
    """The context under which the reference computes in bfloat16."""
    return _Bf16()
