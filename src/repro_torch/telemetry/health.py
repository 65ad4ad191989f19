"""On-device quant health scalars, the port of
``repro/telemetry/health.py``.

``quant_health`` runs on (params, grads) after the gradient, inside the
train step, and returns ``"qh/<group>/<metric>"`` 0-d tensors that ride
the metrics dict; the trainer fetches them with the loss at its flush
points, so they add no host sync. Per layer group (embed / attn / mlp /
other, by the first substring of the leaf path):

* ``w_absmax`` (every quantized mode): max |w|, which sets the
  tensor-quantize scale;
* ``int8_sat_frac`` (int8 modes): the fraction of weight elements that
  tensor-quantize to the clip value ±127;
* ``fp8_fallback_frac`` (``fp8_mixed``): the fraction of gradient tiles
  that the dynamic-fallback criterion (tile absmax > ratio x the median,
  the ``fallback_mask`` the mixed kernel's caller applies to activation
  tiles) would route to bf16, over tiles of ``fp8_block_rows`` x
  ``fp8_block_cols`` with leading dims folded into rows. The JAX package
  cannot tap the kernel's own activation mask inside its custom VJP, and
  reads this gradient-tile rate as its proxy; so does the port.

Under the sharded engine (``shards``, its LeafShard tree) each scalar is
the whole tensor's: the absmax a maximum over the ranks, the saturated
fraction a count summed over them, and a split gradient is gathered whole
for the fallback tiles.

On the host, ``qh_items`` and ``summarize_rms`` turn a flush's fetched
metrics into the ``train_step`` event's floats (the App.-D ratio per
group from StableAdamW's RMS_t), with no device work.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed import sharding as S
from repro_torch.kernels.fp8_matmul.ref import block_absmax, fallback_mask
from repro_torch.models.params import tree_map, tree_paths

#: ordered group patterns; the first substring match of the leaf path wins
GROUPS = ("embed", "attn", "mlp")


def group_of(path: str) -> str:
    for g in GROUPS:
        if g in path:
            return g
    return "other"


def _grouped_leaves(tree, shards=None, min_ndim: int = 2):
    """{group: [(leaf, its LeafShard or None), ...]} for float leaves with
    ndim >= min_ndim (norm gains and biases are vectors and are not
    quantized; stacked over the layer groups they are matrices and land in
    "other", as in JAX)."""
    sh = dict(tree_paths(tree_map(lambda _, s: s, tree, shards))) if shards is not None else {}
    out: Dict[str, list] = {}
    for path, leaf in tree_paths(tree):
        if leaf.dim() < min_ndim or not leaf.is_floating_point():
            continue
        out.setdefault(group_of(path), []).append((leaf, sh.get(path)))
    return out


def _block_absmax(x: torch.Tensor, br: int, bc: int) -> torch.Tensor:
    """(..., C) -> (⌈R/br⌉, ⌈C/bc⌉) per-tile absmax of the array with its
    leading dims folded into R rows (zero padding cannot raise a tile's
    absmax; not floored, as in the JAX package)."""
    return block_absmax(x.reshape(-1, x.shape[-1]), br, bc)


@torch.no_grad()
def quant_health(params, grads, train_cfg, shards=None) -> Dict[str, torch.Tensor]:
    """Device-side health scalars keyed ``qh/<group>/<metric>``; empty when
    ``train_cfg.quant_health_metrics`` is off or the mode is bf16.
    Independent reductions: they cannot change the update."""
    mode = train_cfg.quant_mode
    if not getattr(train_cfg, "quant_health_metrics", False) or mode == "bf16":
        return {}
    out: Dict[str, torch.Tensor] = {}
    int8 = mode.startswith("int8")
    for group, items in sorted(_grouped_leaves(params, shards).items()):
        leaves, shs = [w for w, _ in items], [s for _, s in items]
        absmaxes = S.reduce_scalars([torch.max(torch.abs(w.float())) for w in leaves], shs, "max")
        out[f"qh/{group}/w_absmax"] = torch.max(torch.stack(absmaxes))
        if int8:
            # tensor-quantize clip fraction: elements whose |w| rounds to
            # the top int8 code under scale absmax/127
            fracs = S.tree_mean([(torch.abs(w.float()) > a * (126.5 / 127.0)).float()
                                 for w, a in zip(leaves, absmaxes)], shs)
            out[f"qh/{group}/int8_sat_frac"] = torch.mean(torch.stack(fracs))
    if mode == "fp8_mixed":
        br, bc = train_cfg.fp8_block_rows, train_cfg.fp8_block_cols
        ratio = train_cfg.fp8_fallback_ratio
        for group, items in sorted(_grouped_leaves(grads, shards).items()):
            fracs = [torch.mean(fallback_mask(_block_absmax(g if s is None else s.gather(g),
                                                            br, bc), ratio))
                     for g, s in items]
            out[f"qh/{group}/fp8_fallback_frac"] = torch.mean(torch.stack(fracs))
    return out


# -- host-side helpers (on fetched metrics) -----------------------------------

def qh_items(metrics: Dict) -> Dict[str, float]:
    """The qh/ scalars of one fetched metrics dict, as floats."""
    return {k: float(v) for k, v in metrics.items() if k.startswith("qh/")}


def summarize_rms(rms_tree) -> Dict[str, float]:
    """Per-group mean of the fetched StableAdamW RMS_t tree (the paper's
    App.-D ``sqrt(E[g²]/v_t)`` spike-precursor signal), grouped like the
    device-side health metrics."""
    groups: Dict[str, list] = {}
    for path, leaf in tree_paths(rms_tree):
        groups.setdefault(group_of(path), []).append(float(leaf))
    return {f"qh/{g}/adamw_rms": sum(v) / len(v) for g, v in sorted(groups.items())}
