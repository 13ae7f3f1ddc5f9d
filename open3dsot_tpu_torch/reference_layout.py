"""Torch replicas of the reference's modules, for state dicts in its
Lightning key layout.

A released checkpoint of the reference (P2B / BAT / M2-Track) names its
tensors after the reference's module tree: M2-Track's plain `nn.Sequential`
heads (`motion_mlp.0.weight`, `mini_pointnet.features.3.running_mean`,
`seg_pointnet.seq_per_point.0.0.weight`) and P2B / BAT's pt_utils ones
(SharedMLP `layer{i}.conv` / `layer{i}.bn.bn`, Seq heads `{i}.conv`, convs
without a bias where a BatchNorm follows). `lightning_template(config,
variables)` builds those modules at the widths of a `{'params',
'batch_stats'}` tree (`weights.variables_of(model.net)`) and returns their
state dict (random values), which `export_torch.export_checkpoint` takes as
its template: the checkpoint it writes has the reference's keys and shapes.
No released checkpoint is needed to test the bridge.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from open3dsot_tpu_torch.export_torch import _trace_mapping


def _layers(tree: dict) -> list:
    """(in, out) of each `layer{i}` Dense of an MLP subtree, in order."""
    n = sum(1 for k in tree if k.startswith("layer"))
    return [tuple(tree[f"layer{i}"]["dense"]["kernel"].shape) for i in range(n)]


def _widths(tree: dict) -> list:
    shapes = _layers(tree)
    return [shapes[0][0]] + [o for _, o in shapes]


def _plain_mlp(widths) -> nn.Sequential:
    """Linear, BN, ReLU, ..., Linear (the M2 heads)."""
    mods = []
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        mods.append(nn.Linear(cin, cout))
        if i < len(widths) - 2:
            mods += [nn.BatchNorm1d(cout), nn.ReLU()]
    return nn.Sequential(*mods)


class _MiniPointNet(nn.Module):
    def __init__(self, per_point, hidden):
        super().__init__()
        seq = []
        for cin, cout in zip(per_point[:-1], per_point[1:]):
            seq += [nn.Conv1d(cin, cout, 1), nn.BatchNorm1d(cout), nn.ReLU()]
        seq += [nn.AdaptiveMaxPool1d(output_size=1), nn.Flatten()]
        for cin, cout in zip(hidden[:-1], hidden[1:]):
            seq += [nn.Linear(cin, cout), nn.BatchNorm1d(cout), nn.ReLU()]
        self.features = nn.Sequential(*seq)


class _SegPointNet(nn.Module):
    def __init__(self, mlp1, mlp2, fc):
        super().__init__()
        unit = lambda cin, cout: nn.Sequential(nn.Conv1d(cin, cout, 1),  # noqa: E731
                                               nn.BatchNorm1d(cout), nn.ReLU())
        self.seq_per_point = nn.ModuleList(unit(i, o) for i, o in mlp1)
        self.seq_per_point2 = nn.ModuleList(unit(i, o) for i, o in mlp2)
        self.fc = nn.Conv1d(*fc, 1)


class _BN(nn.Module):
    """pt_utils _BNBase: a wrapper whose child is named `bn`."""

    def __init__(self, ch, dims):
        super().__init__()
        self.bn = nn.BatchNorm1d(ch) if dims == 1 else nn.BatchNorm2d(ch)


class _ConvUnit(nn.Module):
    """pt_utils _ConvBase: `conv` (no bias under a BN) and `bn`."""

    def __init__(self, cin, cout, bn, dims):
        super().__init__()
        self.conv = (nn.Conv1d if dims == 1 else nn.Conv2d)(cin, cout, 1, bias=not bn)
        if bn:
            self.bn = _BN(cout, dims)


def _pt_seq(widths, dims: int = 1) -> nn.Sequential:
    """pt_utils Seq of convs, the last one plain."""
    n = len(widths) - 1
    return nn.Sequential(*(_ConvUnit(i, o, k < n - 1, dims)
                           for k, (i, o) in enumerate(zip(widths[:-1], widths[1:]))))


class _SharedMLP(nn.Module):
    def __init__(self, widths):
        super().__init__()
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"layer{i}", _ConvUnit(cin, cout, True, 2))


class _SA(nn.Module):
    def __init__(self, widths):
        super().__init__()
        self.mlps = nn.ModuleList([_SharedMLP(widths)])


class _Backbone(nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.SA_modules = nn.ModuleList(_SA(_widths(tree[f"sa{i}"]["mlp_shared"]))
                                        for i in range(3))


def _m2track(p: dict) -> Dict[str, nn.Module]:
    seg = p["seg_pointnet"]
    mlp1 = [tuple(seg[f"mlp1_{i}"]["layer0"]["dense"]["kernel"].shape)
            for i in range(sum(k.startswith("mlp1_") for k in seg))]
    mlp2 = [tuple(seg[f"mlp2_{i}"]["layer0"]["dense"]["kernel"].shape)
            for i in range(sum(k.startswith("mlp2_") for k in seg))]
    mods = {"seg_pointnet": _SegPointNet(mlp1, mlp2, seg["fc"]["kernel"].shape)}
    for name in ("mini_pointnet", "mini_pointnet2"):
        if name in p:
            mods[name] = _MiniPointNet(_widths(p[name]["per_point"]), _widths(p[name]["hidden"]))
    for name in ("motion_mlp", "motion_state_mlp", "final_mlp", "box_mlp"):
        if name in p:
            mods[name] = _plain_mlp(_widths(p[name]))
    return mods


def _rpn(p: dict) -> nn.Module:
    rpn = nn.Module()
    for name in ("FC_layer_cla", "vote_layer", "FC_proposal"):
        rpn.add_module(name, _pt_seq(_widths(p[name])))
    rpn.vote_aggregation = _SA(_widths(p["vote_aggregation"]["mlp_shared"]))
    return rpn


def _matching(p: dict, bat: bool) -> Dict[str, nn.Module]:
    xcorr = nn.Module()
    xcorr.mlp = _SharedMLP(_widths(p["xcorr"]["mlp"]))
    xcorr.fea_layer = _pt_seq(_widths(p["xcorr"]["fea_layer"]))
    mods = {"backbone": _Backbone(p["backbone"]),
            "conv_final": nn.Conv1d(*p["conv_final"]["kernel"].shape, 1),
            "xcorr": xcorr, "rpn": _rpn(p["rpn"])}
    if bat:
        mods["mlp_bc"] = _pt_seq(_widths(p["mlp_bc"]))
    return mods


def lightning_template(config, variables: dict, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's state dict for `config.net_model` at the widths of
    `variables`, in its Lightning key layout, with random values from `seed`
    (no `num_batches_tracked`)."""
    name = config.net_model.lower()
    p = variables["params"]
    torch.manual_seed(seed)
    mods = _m2track(p) if name == "m2track" else _matching(p, bat=name == "bat")
    return {f"{prefix}.{k}": v.detach().clone()
            for prefix, mod in mods.items() for k, v in mod.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def without_suppressed_biases(variables: dict, config, template) -> dict:
    """A copy of `variables` with the Dense biases that have no slot in
    `template` (its convs under a BatchNorm carry none) set to zero. Export
    folds those biases into the BatchNorm's running mean; at zero that fold
    changes nothing, so the exported checkpoint imports back to the same
    tree bit for bit."""
    _, folded = _trace_mapping({k: np.asarray(v) for k, v in template.items()}, config)
    out = copy.deepcopy(variables)
    for path in folded:
        node = out["params"]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = np.zeros_like(node[path[-1]])
    return out
