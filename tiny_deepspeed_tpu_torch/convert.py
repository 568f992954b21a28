# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Weights between the JAX package and the port, through numpy.

The JAX package's parameters are a flat dict of dotted names with the L
transformer blocks stacked on a leading axis ("h.attn.qkv.w": (L, d, 3d)),
linear weights (in, out).  The port keeps exactly that name space and
layout (`GPT2Model.named_parameters()`), so conversion is a dtype- and
device-preserving copy — how the tests give both sides the same weights.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch


def params_from_numpy(flat: Dict[str, np.ndarray],
                      device: Union[str, torch.device]
                      ) -> Dict[str, torch.Tensor]:
    """{dotted name: array} -> {dotted name: tensor on `device`}, ready for
    `GPT2Model.load_state_dict`."""
    out = {}
    for name, a in flat.items():
        a = np.asarray(a)
        if a.dtype.kind not in "fiu":
            # bf16 and other non-numpy-native leaves arrive as f32
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The inverse: a GPT2Model or {name: tensor} -> {name: f32/int array}."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()
        out[name] = t.numpy()
    return out
