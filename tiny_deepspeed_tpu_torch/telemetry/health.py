# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Training-health metrics, computed on the device inside the step.

Counterpart of `tiny_deepspeed_tpu/telemetry/health.py`, all of it, with
its field orders and its host-side readers.  `health_vector` packs the
step's health into ONE (5,) f32 tensor, so reading it costs one
device->host transfer — the cost of reading the loss, which rides at
element 0.  The reductions are plain PyTorch: JAX's are plain `jnp`
too, with no Pallas kernel behind them.

All norms are GLOBAL.  JAX gets that from GSPMD, whose sums run over
the logical arrays; the port's engine (parallel/engine.py) sums what
each rank holds and all-reduces the packed partial sums once over the
data group under ZeRO-1/2/3, so every rank reports the same numbers.
The functions here take the pieces a rank holds and return its partial
sums; `health_vector` takes finished sums or whole trees.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

# element order of the packed vector; "loss" MUST stay first — the step
# timer's closing sync reads element 0 as the step's loss
HEALTH_FIELDS = (
    "loss", "grad_norm", "update_norm", "param_norm", "nonfinite_grads",
)

# column order of the (n_layer, 6) layer-health matrix: the first four
# from the probe tap (parallel/schedule.layer_health_tap: forward
# activation stats, backward activation-gradient stats), the last two
# from the stacked "h.*" gradient leaves after the backward
LAYER_FIELDS = (
    "act_norm", "act_nonfinite",
    "dact_norm", "dact_nonfinite",
    "grad_norm", "grad_nonfinite",
)


def sq_sum(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of squares, in f32, over every element of `tensors`."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum()


def nonfinite(t: torch.Tensor, dim=None) -> torch.Tensor:
    """Count (f32) of t's non-finite elements (over `dim`, or all): t - t
    is NaN exactly where t is inf or NaN.  Three launches on the card,
    where `~torch.isfinite` takes five (isfinite is composite)."""
    bad = torch.isnan(t - t)
    if dim is None:
        return bad.sum(dtype=torch.float32)
    return bad.sum(dim=dim, dtype=torch.float32)


def nonfinite_count(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Count (f32) of the non-finite elements of `tensors`."""
    return torch.stack([nonfinite(t) for t in tensors]).sum()


def health_partials(grads, params, usq) -> torch.Tensor:
    """(4,) f32 [grad sq-sum, update sq-sum, param sq-sum, non-finite
    grad count] over the pieces given: {name: tensor} gradients and
    params (whole leaves, or a rank's shards), `usq` the update's
    sq-sum (a 0-d tensor: the update runs in place, so the engine sums
    (new - old)^2 leaf by leaf as it updates)."""
    g = list(grads.values())
    return torch.stack([sq_sum(g), usq.float().reshape(()),
                        sq_sum(params.values()), nonfinite_count(g)])


def health_vector(loss, grads=None, params=None, new_params=None, *,
                  partials: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(5,) f32: [loss, grad L2 norm, update L2 norm, new-param L2 norm,
    non-finite grad element count] — JAX's signature (whole trees:
    `grads`, the params before the update and after it), or from the
    global `partials` of `health_partials`."""
    if partials is None:
        usq = torch.stack([(n.float() - o.float()).square().sum()
                           for n, o in zip(new_params.values(),
                                           params.values())]).sum()
        partials = health_partials(grads, new_params, usq)
    loss = torch.as_tensor(loss, dtype=torch.float32,
                           device=partials.device).reshape(())
    return torch.stack([loss, partials[0].sqrt(), partials[1].sqrt(),
                        partials[2].sqrt(), partials[3]])


def health_dict(vec) -> Dict[str, float]:
    """Host-side unpack of a (5,) health vector (tensor or numpy)."""
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().cpu().numpy()
    vals = np.asarray(vec).ravel()
    out = {k: float(v) for k, v in zip(HEALTH_FIELDS, vals)}
    out["nonfinite_grads"] = int(out["nonfinite_grads"])
    return out


# ---------------------------------------------------------------------------
# per-layer health (engine telemetry layers mode)
# ---------------------------------------------------------------------------

def layer_grad_stats(grads, n_layer: Optional[int] = None) -> torch.Tensor:
    """(n_layer, 2) f32 [grad sq-sum, non-finite count] per layer, summed
    over the stacked "h.*" gradient leaves (their leading axis is the
    layer axis; an (L, own) ZeRO-3 shard sums its own elements)."""
    gsq = nf = 0.0
    for name, g in grads.items():
        if not name.startswith("h."):
            continue
        gf = g.float().reshape(g.shape[0], -1)
        gsq = gsq + gf.square().sum(dim=1)
        nf = nf + nonfinite(gf, dim=1)
    return torch.stack([gsq, nf], dim=-1)


def flat_layer_grad_stats(pieces, n_layer: int, device) -> torch.Tensor:
    """`layer_grad_stats` of flat shards: `pieces` is [(g, lo, per)] —
    the elements [lo, lo + g.numel()) of a whole flat "h.*" leaf whose
    layers hold `per` elements each — summed layer by layer."""
    out = torch.zeros(n_layer, 2, dtype=torch.float32, device=device)
    for g, lo, per in pieces:
        gf = g.float().reshape(-1)
        hi = lo + gf.numel()
        for l in range(lo // per, -(-hi // per)):
            a, z = max(lo, l * per) - lo, min(hi, (l + 1) * per) - lo
            if z > a:
                s = gf[a:z]
                out[l, 0] += s.square().sum()
                out[l, 1] += nonfinite(s)
    return out


def layer_health_matrix(probe_grad, grads=None, *,
                        grad_stats: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(n_layer, 6) f32 layer-health matrix (columns LAYER_FIELDS) from
    the probe tap's cotangent ((L, 4): act / dact sq-sums and non-finite
    counts) and the gradient tree (or its `layer_grad_stats`).  Sq-sums
    become norms here, once, so accumulation can sum raw cotangents."""
    g = layer_grad_stats(grads) if grad_stats is None else grad_stats
    p = probe_grad.float()
    return torch.stack([p[:, 0].sqrt(), p[:, 1], p[:, 2].sqrt(), p[:, 3],
                        g[:, 0].sqrt(), g[:, 1]], dim=-1)


def first_nonfinite_layer(mat):
    """(layer index, LAYER_FIELDS column name) of the layer where
    non-finiteness ORIGINATED, or None when every count is zero.
    Host-side.  A forward overflow at layer k poisons activations k..L-1,
    so the source is the FIRST layer with non-finite activations; a
    backward-only overflow propagates toward layer 0, so the source is
    the LAST layer with non-finite activation gradients; a dW-only
    overflow stays local, so any layer with non-finite grads names
    itself."""
    if isinstance(mat, torch.Tensor):
        mat = mat.detach().cpu().numpy()
    m = np.asarray(mat)
    act, dact, grad = m[:, 1], m[:, 3], m[:, 5]
    if np.any(act > 0):
        return int(np.argmax(act > 0)), "act_nonfinite"
    if np.any(dact > 0):
        return int(len(dact) - 1 - np.argmax(dact[::-1] > 0)), \
            "dact_nonfinite"
    if np.any(grad > 0):
        return int(np.argmax(grad > 0)), "grad_nonfinite"
    return None
