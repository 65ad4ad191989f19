"""On-device quant health scalars, the int8 part of
``repro/telemetry/health.py``.

``quant_health`` runs on (params, grads) after the gradient, inside the
train step, and returns ``"qh/<group>/<metric>"`` 0-d tensors that ride
the metrics dict; the trainer fetches them with the loss at its flush
points, so they add no host sync. Per layer group (embed / attn / mlp /
other, by the first substring of the leaf path):

* ``w_absmax``: max |w|, the tensor-quantize scale driver;
* ``int8_sat_frac`` (int8 modes): the fraction of weight elements that
  tensor-quantize to the clip value ±127.

The fp8_mixed fallback-block fraction comes with the fp8 datapath
(ROADMAP.md Queue 1): ``quant_health`` raises for that mode.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.params import tree_paths

#: ordered group patterns; the first substring match of the leaf path wins
GROUPS = ("embed", "attn", "mlp")


def group_of(path: str) -> str:
    for g in GROUPS:
        if g in path:
            return g
    return "other"


def _grouped_leaves(tree, min_ndim: int = 2):
    """{group: [leaf, ...]} for float leaves with ndim >= min_ndim (norm
    gains and biases are vectors and are not quantized; stacked over the
    layer groups they are matrices and land in "other", as in JAX)."""
    out: Dict[str, list] = {}
    for path, leaf in tree_paths(tree):
        if leaf.dim() < min_ndim or not leaf.is_floating_point():
            continue
        out.setdefault(group_of(path), []).append(leaf)
    return out


@torch.no_grad()
def quant_health(params, grads, train_cfg) -> Dict[str, torch.Tensor]:
    """Device-side health scalars keyed ``qh/<group>/<metric>``; empty when
    ``train_cfg.quant_health_metrics`` is off or the mode is bf16.
    Independent reductions: they cannot change the update."""
    mode = train_cfg.quant_mode
    if not getattr(train_cfg, "quant_health_metrics", False) or mode == "bf16":
        return {}
    if mode == "fp8_mixed":
        raise NotImplementedError(
            "the fp8_mixed fallback-fraction health metric comes with the fp8 "
            "datapath (ROADMAP.md Queue 1)")
    out: Dict[str, torch.Tensor] = {}
    int8 = mode.startswith("int8")
    for group, leaves in sorted(_grouped_leaves(params).items()):
        absmaxes = [torch.max(torch.abs(w.float())) for w in leaves]
        out[f"qh/{group}/w_absmax"] = torch.max(torch.stack(absmaxes))
        if int8:
            # tensor-quantize clip fraction: elements whose |w| rounds to
            # the top int8 code under scale absmax/127
            fracs = [torch.mean((torch.abs(w.float()) > a * (126.5 / 127.0)).float())
                     for w, a in zip(leaves, absmaxes)]
            out[f"qh/{group}/int8_sat_frac"] = torch.mean(torch.stack(fracs))
    return out
