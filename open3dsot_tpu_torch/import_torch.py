"""Torch/Lightning checkpoint importer, port of `open3dsot_tpu/import_torch.py`.

Maps the reference's released `.ckpt` state_dicts (P2B / BAT / M2-Track,
Lightning modules) onto the JAX package's `{'params', 'batch_stats'}` numpy
tree, which `weights.py::state_dict_from_jax` turns into the port's state
dict (the port's modules carry the flax names).

Conversions:
- Conv1d (out,in,1) / Conv2d (out,in,1,1) / Linear (out,in) torch weights ->
  channels-last Dense kernels (in,out).
- torch BatchNorm{1,2}d -> BatchNorm: weight->scale, bias->bias,
  running_mean/var -> batch_stats.
- pt_utils naming: SharedMLP -> `layer{i}.conv` / `layer{i}.bn.bn`;
  fluent Seq heads -> numeric children `0.conv`, `0.bn.bn`, ...

Missing torch keys (the conv bias suppressed when bn=True) are zero-filled.
A released `.ckpt` pickles its hyper-parameters, so `load_torch_state_dict`
loads it with `weights_only=False`, which runs the file's pickle code: load
only checkpoints from a source you trust.

`import_checkpoint(..., model=)` checks the imported tree against the port
model's own weights (`weights.py::variables_of`), leaf by leaf: the same
structure and shapes, else a ValueError with the JAX package's messages.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a Lightning .ckpt or raw state_dict into numpy arrays."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _w_conv(w: np.ndarray) -> np.ndarray:
    """torch conv kernel-size-1 weight -> Dense kernel (in, out)."""
    while w.ndim > 2:
        w = w[..., 0]
    return np.ascontiguousarray(w.T)


def _assign(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value



def _j(prefix: str, rest: str) -> str:
    return f"{prefix}.{rest}" if prefix else rest

class ImportMap:
    """Accumulates (params, batch_stats) assignments from torch keys."""

    def __init__(self, state_dict: Dict[str, np.ndarray]):
        self.sd = state_dict
        self.params: dict = {}
        self.batch_stats: dict = {}
        self.used: set = set()

    def dense(self, torch_prefix: str, flax_path: Tuple[str, ...], transpose=True):
        w_key, b_key = torch_prefix + ".weight", torch_prefix + ".bias"
        w = self.sd[w_key]
        self.used.add(w_key)
        kernel = _w_conv(w) if transpose else w
        _assign(self.params, flax_path + ("kernel",), kernel)
        if b_key in self.sd:
            _assign(self.params, flax_path + ("bias",), self.sd[b_key])
            self.used.add(b_key)
        else:
            # torch convs suppress the bias when followed by BN
            # (pytorch_utils.py:90); our Dense always carries one — zero it
            _assign(
                self.params,
                flax_path + ("bias",),
                np.zeros(kernel.shape[-1], dtype=kernel.dtype),
            )

    def bn(self, torch_prefix: str, flax_path: Tuple[str, ...]):
        _assign(self.params, flax_path + ("scale",), self.sd[torch_prefix + ".weight"])
        _assign(self.params, flax_path + ("bias",), self.sd[torch_prefix + ".bias"])
        _assign(self.batch_stats, flax_path + ("mean",), self.sd[torch_prefix + ".running_mean"])
        _assign(self.batch_stats, flax_path + ("var",), self.sd[torch_prefix + ".running_var"])
        for suf in (".weight", ".bias", ".running_mean", ".running_var"):
            self.used.add(torch_prefix + suf)

    # --- composite structures -------------------------------------------
    def plain_sequential_mlp(self, torch_prefix: str, flax_path: Tuple[str, ...],
                             n_layers: int, final_plain: bool = True):
        """nn.Sequential(Linear/Conv, BN, ReLU, ... , Linear): torch indices
        0,1 / 3,4 / 6,... -> flax layer{i}/dense,bn."""
        t = 0
        for i in range(n_layers):
            last = i == n_layers - 1
            self.dense(_j(torch_prefix, f"{t}"), flax_path + (f"layer{i}", "dense"))
            if not (final_plain and last):
                self.bn(_j(torch_prefix, f"{t + 1}"), flax_path + (f"layer{i}", "bn"))
                t += 3
            else:
                t += 1

    def pt_seq(self, torch_prefix: str, flax_path: Tuple[str, ...], n_layers: int,
               final_plain: bool = True):
        """pt_utils Seq: children `{i}.conv` + `{i}.bn.bn` -> layer{i}."""
        for i in range(n_layers):
            last = i == n_layers - 1
            self.dense(_j(torch_prefix, f"{i}.conv"), flax_path + (f"layer{i}", "dense"))
            if not (final_plain and last):
                self.bn(_j(torch_prefix, f"{i}.bn.bn"), flax_path + (f"layer{i}", "bn"))

    def shared_mlp(self, torch_prefix: str, flax_path: Tuple[str, ...], n_layers: int):
        """pt_utils SharedMLP: `layer{i}.conv` + `layer{i}.bn.bn`."""
        for i in range(n_layers):
            self.dense(_j(torch_prefix, f"layer{i}.conv"), flax_path + (f"layer{i}", "dense"))
            self.bn(_j(torch_prefix, f"layer{i}.bn.bn"), flax_path + (f"layer{i}", "bn"))

    def mini_pointnet(self, torch_prefix: str, flax_path: Tuple[str, ...],
                      n_per_point: int, n_hidden: int):
        """MiniPointNet.features Sequential (pointnet.py:120-123): conv/bn
        triplets, maxpool, flatten, linear/bn triplets."""
        t = 0
        for i in range(n_per_point):
            self.dense(_j(torch_prefix, f"features.{t}"), flax_path + ("per_point", f"layer{i}", "dense"))
            self.bn(_j(torch_prefix, f"features.{t + 1}"), flax_path + ("per_point", f"layer{i}", "bn"))
            t += 3
        t += 2  # AdaptiveMaxPool1d, Flatten
        for i in range(n_hidden):
            self.dense(_j(torch_prefix, f"features.{t}"), flax_path + ("hidden", f"layer{i}", "dense"))
            self.bn(_j(torch_prefix, f"features.{t + 1}"), flax_path + ("hidden", f"layer{i}", "bn"))
            t += 3

    def seg_pointnet(self, torch_prefix: str, flax_path: Tuple[str, ...],
                     n_mlp1: int, n_mlp2: int):
        for i in range(n_mlp1):
            self.dense(_j(torch_prefix, f"seq_per_point.{i}.0"), flax_path + (f"mlp1_{i}", "layer0", "dense"))
            self.bn(_j(torch_prefix, f"seq_per_point.{i}.1"), flax_path + (f"mlp1_{i}", "layer0", "bn"))
        for i in range(n_mlp2):
            self.dense(_j(torch_prefix, f"seq_per_point2.{i}.0"), flax_path + (f"mlp2_{i}", "layer0", "dense"))
            self.bn(_j(torch_prefix, f"seq_per_point2.{i}.1"), flax_path + (f"mlp2_{i}", "layer0", "bn"))
        self.dense(_j(torch_prefix, "fc"), flax_path + ("fc",))

    def backbone(self, torch_prefix: str, flax_path: Tuple[str, ...]):
        """Pointnet_Backbone: 3 SA modules, each SharedMLP of 3 layers."""
        for i in range(3):
            self.shared_mlp(
                _j(torch_prefix, f"SA_modules.{i}.mlps.0"),
                flax_path + (f"sa{i}", "mlp_shared"),
                3,
            )

    def finish(self) -> Dict[str, Any]:
        return {"params": self.params, "batch_stats": self.batch_stats}


def import_m2track(state_dict: Dict[str, np.ndarray], config) -> Dict[str, Any]:
    m = ImportMap(state_dict)
    m.seg_pointnet("seg_pointnet", ("seg_pointnet",), 5, 4)
    m.mini_pointnet("mini_pointnet", ("mini_pointnet",), 4, 2)
    m.plain_sequential_mlp("motion_mlp", ("motion_mlp",), 3)
    if getattr(config, "use_motion_cls", True):
        m.plain_sequential_mlp("motion_state_mlp", ("motion_state_mlp",), 3)
    if getattr(config, "use_prev_refinement", True):
        m.plain_sequential_mlp("final_mlp", ("final_mlp",), 3)
    if getattr(config, "use_second_stage", True):
        m.mini_pointnet("mini_pointnet2", ("mini_pointnet2",), 4, 2)
        m.plain_sequential_mlp("box_mlp", ("box_mlp",), 3)
    return m.finish()


def _import_rpn(m: ImportMap, prefix: str = "rpn"):
    m.pt_seq(f"{prefix}.FC_layer_cla", (prefix, "FC_layer_cla"), 3)
    m.pt_seq(f"{prefix}.vote_layer", (prefix, "vote_layer"), 3)
    m.shared_mlp(f"{prefix}.vote_aggregation.mlps.0", (prefix, "vote_aggregation", "mlp_shared"), 3)
    m.pt_seq(f"{prefix}.FC_proposal", (prefix, "FC_proposal"), 3)


def import_p2b(state_dict: Dict[str, np.ndarray], config) -> Dict[str, Any]:
    m = ImportMap(state_dict)
    m.backbone("backbone", ("backbone",))
    m.dense("conv_final", ("conv_final",))
    m.shared_mlp("xcorr.mlp", ("xcorr", "mlp"), 3)
    m.pt_seq("xcorr.fea_layer", ("xcorr", "fea_layer"), 2)
    _import_rpn(m)
    return m.finish()


def import_bat(state_dict: Dict[str, np.ndarray], config) -> Dict[str, Any]:
    m = ImportMap(state_dict)
    m.backbone("backbone", ("backbone",))
    m.dense("conv_final", ("conv_final",))
    m.pt_seq("mlp_bc", ("mlp_bc",), 3)
    m.shared_mlp("xcorr.mlp", ("xcorr", "mlp"), 3)
    m.pt_seq("xcorr.fea_layer", ("xcorr", "fea_layer"), 2)
    _import_rpn(m)
    return m.finish()


_IMPORTERS = {"m2track": import_m2track, "p2b": import_p2b, "bat": import_bat}


def import_checkpoint(path_or_sd, config, model=None) -> Dict[str, Any]:
    """Torch ckpt (path or state_dict) -> `{'params', 'batch_stats'}` for
    `config.net_model`.

    When `model` (the port's model, `get_model(name)(cfg)`) is given, the
    imported tree is checked leaf by leaf against the model's own weights
    (same structure, same shapes), and leaves the checkpoint lacks are taken
    from them.
    """
    sd = path_or_sd
    if isinstance(path_or_sd, str):
        sd = load_torch_state_dict(path_or_sd)
    imported = _IMPORTERS[config.net_model.lower()](sd, config)
    if model is not None:
        from open3dsot_tpu_torch.weights import variables_of

        imported = _merge_with_init(variables_of(model.net), imported)
    return imported


def _merge_with_init(init_tree, imported_tree):
    """Recursively overlay imported leaves onto the init tree, checking shapes."""

    def merge(init_node, imp_node, path=""):
        if not isinstance(imp_node, dict):
            got, want = np.shape(imp_node), np.shape(init_node)
            if got != want:
                raise ValueError(f"shape mismatch at {path}: ckpt {got} vs model {want}")
            return np.asarray(imp_node, dtype=np.asarray(init_node).dtype)
        out = {}
        for k in init_node:
            if isinstance(imp_node, dict) and k in imp_node:
                out[k] = merge(init_node[k], imp_node[k], f"{path}/{k}")
            else:
                out[k] = init_node[k]
        extra = set(imp_node) - set(init_node)
        if extra:
            raise ValueError(f"imported keys not in model at {path}: {sorted(extra)}")
        return out

    return {
        "params": merge(dict(init_tree["params"]), imported_tree["params"], "params"),
        "batch_stats": merge(
            dict(init_tree.get("batch_stats", {})), imported_tree["batch_stats"], "batch_stats"
        ),
    }
