"""Carry the JAX package's parameters over to the port, through numpy.

`from_jax_params(tree, cfg)` takes a JAX param tree whose leaves are numpy
arrays (`jax.tree.map(np.asarray, params)`), in the train layout of
`transformer.init` or the packed serve layout of `pack_for_serve`, and
returns the port's params:
  * uint32 packed words (the bit-plane stacks `w_planes` included) become
    int32 tensors with their bits unchanged;
  * bfloat16 arrays (numpy's `ml_dtypes` extension type) are carried bit
    for bit;
  * the reference's stacked `mid` periods (a leading n_periods axis over
    the scanned layers) are unstacked into the port's per-layer list,
    ordered first, mid periods, remainder layers, last; only that period
    axis is indexed, so an MoE layer's expert stacks keep their expert
    axis.
The bridge itself imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(a) -> torch.Tensor:
    a = np.array(a, order="C")              # a C-ordered copy, 0-d kept 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)


def from_jax_params(tree: dict, cfg) -> dict:
    n_pattern = len(cfg.block_pattern)
    blocks = [tree["first"]]
    if "mid" in tree:
        mid = tree["mid"]
        n_periods = len(_first_leaf(mid))
        for i in range(n_periods):
            for t in range(n_pattern):
                blocks.append(_tree(mid[f"b{t}"], lambda a, i=i: np.asarray(a)[i]))
    t = 0
    while f"rem{t}" in tree:
        blocks.append(tree[f"rem{t}"])
        t += 1
    blocks.append(tree["last"])
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree holds {len(blocks)} blocks, cfg has {cfg.n_layers}")
    out = {"embed": _tree(tree["embed"], to_torch),
           "blocks": [_tree(b, to_torch) for b in blocks],
           "final_norm": _tree(tree["final_norm"], to_torch)}
    if "lm_head" in tree:
        out["lm_head"] = _tree(tree["lm_head"], to_torch)
    return out


def _first_leaf(t):
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return np.asarray(t)
