"""``ParamCasts``: counts the casts of a model's parameters and buffers at
use, each a kernel launch on the card.  The loader's tests and
``chip_smoke.py``'s ``weights`` phase hold a steady stream step of a model
cast once (``utils.convert.cast_params_for_inference``) to none."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


class ParamCasts(TorchFunctionMode):
    """Counts, while active, the calls that cast a parameter or buffer of
    ``model`` (or a view of one) to another dtype: on the card each is a
    kernel launch.  ``count`` the calls, ``names`` the tensors' names.
    Casts of a cast copy (``ops.layers.cast_once``'s) are not counted."""

    _CASTS = {torch.Tensor.to, torch.Tensor.float, torch.Tensor.bfloat16,
              torch.Tensor.half, torch.Tensor.double, torch.Tensor.type}

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self._storages = {
            t.untyped_storage().data_ptr(): name for name, t in
            [*model.named_parameters(), *model.named_buffers()]}
        self.count = 0
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self._CASTS and args and isinstance(out, torch.Tensor) \
                and isinstance(args[0], torch.Tensor) \
                and out.dtype != args[0].dtype:
            name = self._storages.get(args[0].untyped_storage().data_ptr())
            if name is not None:
                self.count += 1
                self.names.append(name)
        return out
