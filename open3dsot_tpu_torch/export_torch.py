"""Torch/Lightning checkpoint exporter, port of `open3dsot_tpu/export_torch.py`:
the inverse of import_torch.py.

Lets a model trained with the port be loaded by the reference stack
(`load_from_checkpoint` / `load_state_dict` on its Lightning modules). The
port's weights go in as the `{'params', 'batch_stats'}` numpy tree of its
flax-style names: `weights.py::variables_of(model.net)`.

The mapping is recovered mechanically from the importer itself, so the two
directions can never drift: every tensor of a TEMPLATE torch state_dict
(from the reference model class or any released .ckpt of the same config)
is tagged with a unique constant, run through the importer, and the
resulting tree tells exactly which torch key each leaf came from and which
transform it took. Export then replays the values backwards:

- Dense kernels (in, out) -> torch conv/linear weights, transposed and
  reshaped to the template's shape ((out,in), (out,in,1) or (out,in,1,1));
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
- Dense biases torch suppresses (conv followed by BN) have no torch slot;
  they are FOLDED into the following BatchNorm's running_mean in float64
  (BN(Wx + b) == BN'(Wx) with mean' = mean - b), so the exported function
  is identical even when training moved those biases off zero;
- template keys the importer never consumes (e.g. torchmetrics buffers in a
  Lightning ckpt) pass through from the template unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from open3dsot_tpu_torch.import_torch import _IMPORTERS, load_torch_state_dict


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _trace_mapping(template_sd: Dict[str, np.ndarray], config):
    """Run the importer on a tagged template; recover tree-path -> torch-key.

    Returns (mapping, folded) where mapping[(collection, path)] = torch_key
    and folded is the list of params paths of torch-suppressed dense biases.
    """
    keys = sorted(template_sd)
    tagged = {
        k: np.full(np.shape(template_sd[k]), float(i + 1), np.float32)
        for i, k in enumerate(keys)
    }
    imported = _IMPORTERS[config.net_model.lower()](tagged, config)
    mapping: Dict[tuple, str] = {}
    folded = []
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(imported[coll]):
            leaf = np.asarray(leaf)
            t0 = float(leaf.flat[0])
            if leaf.size and not np.all(leaf == t0):
                raise AssertionError(
                    f"importer mixed torch keys into one leaf at {coll}/{path}"
                )
            if not (float(t0).is_integer() and 0 <= t0 <= len(keys)):
                raise AssertionError(
                    f"importer transformed a tag non-structurally at "
                    f"{coll}/{path} (traced value {t0}) — the tag-trace "
                    f"inversion only supports value-preserving mappings"
                )
            if t0 == 0.0:
                # the importer zero-fills exactly the torch-suppressed biases
                assert path[-2:] == ("dense", "bias"), (coll, path)
                folded.append(path)
            else:
                mapping[(coll, path)] = keys[int(round(t0)) - 1]
    return mapping, folded


def export_checkpoint(variables: Dict[str, Any], config,
                      template) -> Dict[str, np.ndarray]:
    """`{'params', 'batch_stats'}` variables -> torch state_dict (numpy values).

    template: a torch state_dict (dict of arrays/tensors), or a path to a
    .ckpt to take key names and tensor shapes from — build one with the
    reference model class of the SAME config, or reuse a released ckpt.
    """
    if isinstance(template, str):
        template_sd = load_torch_state_dict(template)
    else:
        template_sd = {k: np.asarray(v) for k, v in template.items()}
    mapping, folded = _trace_mapping(template_sd, config)

    out = dict(template_sd)  # unconsumed keys (metric buffers, ...) pass through
    covered = set()
    for (coll, path), key in mapping.items():
        covered.add((coll, path))
        v = np.asarray(_get(variables[coll], path), np.float32)
        shape = np.shape(template_sd[key])
        if key.endswith(".weight") and len(shape) >= 2:
            v = np.ascontiguousarray(v.T).reshape(shape)
        else:
            v = v.reshape(shape)
        out[key] = v.astype(np.asarray(template_sd[key]).dtype)

    # fold torch-suppressed dense biases into the following BN running_mean
    for path in folded:
        covered.add(("params", path))
        b = np.asarray(_get(variables["params"], path), np.float64)
        bn_path = path[:-2] + ("bn", "mean")
        key = mapping.get(("batch_stats", bn_path))
        if key is None:
            raise ValueError(
                f"dense bias at {path} has no torch slot and no sibling "
                f"BatchNorm to fold into"
            )
        out[key] = (np.asarray(out[key], np.float64) - b).astype(out[key].dtype)

    # completeness: every leaf must be exported or folded
    missing = [
        (coll, path)
        for coll in ("params", "batch_stats")
        for path, _ in _leaves(variables.get(coll, {}))
        if (coll, path) not in covered
    ]
    if missing:
        raise ValueError(f"flax leaves with no torch mapping: {missing}")
    return out


def save_checkpoint(variables, config, template, path: str):
    """Export and write a Lightning-style .ckpt (torch.save payload with a
    'state_dict' entry) loadable by the reference's --checkpoint flag."""
    import torch

    sd = export_checkpoint(variables, config, template)
    payload = {
        "state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()},
        "hyper_parameters": {"config": dict(vars(config))
                             if not isinstance(config, dict) else config},
    }
    torch.save(payload, path)
    return path
