"""Vendored nuScenes scene-split constants (devkit-free), port of
`open3dsot_tpu/data/nuscenes_splits.py`.

The reference resolves splits through `nuscenes.utils.splits.create_splits_scenes()`,
which requires the nuscenes-devkit at runtime. The split lists are fixed
published constants of the nuScenes v1.0 release, so they belong in-tree.

What ships here:
- `mini_train` / `mini_val` (v1.0-mini): vendored verbatim below.
- `train` / `val` / `test` / `train_detect` / `train_track` (v1.0-trainval /
  v1.0-test, 700/150/150/350/350 scene names): these lists are ~1150 exact
  scene names; shipping a hand-retyped copy risks silent evaluation
  corruption, so they are vendored as `nuscenes_splits_full.json` next to
  this module (`scripts/make_nuscenes_splits.py` writes that file from any
  importable devkit or unpacked devkit source tree; copy it here).

Every full-list resolution is structurally validated (published v1.0
cardinalities 700/150/150/350/350, no duplicates, scene-NNNN names,
disjoint train/val/test) so a corrupted vendored file fails loudly; a
user-supplied splits.json skips only the cardinality check (custom subsets
are legitimate there).

Resolution order used by `get_split_scenes`:
1. in-tree constants (mini splits, plus the full lists once
   `nuscenes_splits_full.json` exists);
2. the nuscenes-devkit, if importable;
3. `{dataroot}/splits.json` (a user-supplied name -> scene-list mapping);
4. a RuntimeError naming the vendoring script.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

# v1.0-mini (nuscenes-devkit splits.py, public constants)
MINI_TRAIN = [
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
]
MINI_VAL = ["scene-0103", "scene-0916"]

_FULL_JSON = os.path.join(os.path.dirname(__file__), "nuscenes_splits_full.json")


def _vendored_splits() -> Dict[str, List[str]]:
    splits: Dict[str, List[str]] = {
        "mini_train": list(MINI_TRAIN),
        "mini_val": list(MINI_VAL),
    }
    if os.path.isfile(_FULL_JSON):
        with open(_FULL_JSON) as f:
            full = json.load(f)
        for k, v in full.items():
            splits[k] = list(v)
        # devkit semantics: train = train_detect + train_track
        if "train" not in splits and {"train_detect", "train_track"} <= full.keys():
            splits["train"] = list(full["train_detect"]) + list(full["train_track"])
    return splits


# Structural invariants of the published v1.0 splits (nuscenes-devkit
# splits.py): sizes, disjointness, scene-name shape. Validated on every
# full-list resolution so a corrupted or hand-edited
# nuscenes_splits_full.json / splits.json fails loudly instead of silently
# skewing evaluation.
_EXPECTED_SIZES = {
    "train": 700, "val": 150, "test": 150,
    "train_detect": 350, "train_track": 350,
    "mini_train": 8, "mini_val": 2,
}


def _validate_full(splits: Dict[str, List[str]], source: str,
                   check_sizes: bool = True) -> None:
    """check_sizes=True for the in-tree nuscenes_splits_full.json (it claims
    to be the published v1.0 constants); a user {dataroot}/splits.json may
    legitimately carry custom subsets, so only the structural checks apply
    there."""
    import re

    pat = re.compile(r"^scene-\d{4}$")
    for name, scenes in splits.items():
        want = _EXPECTED_SIZES.get(name) if check_sizes else None
        if want is not None and len(scenes) != want:
            raise ValueError(
                f"nuScenes split {name!r} from {source} has {len(scenes)} "
                f"scenes, expected {want} (published v1.0 constant)"
            )
        if len(set(scenes)) != len(scenes):
            raise ValueError(f"nuScenes split {name!r} from {source} has "
                             f"duplicate scene names")
        bad = [s for s in scenes if not pat.match(s)]
        if bad:
            raise ValueError(
                f"nuScenes split {name!r} from {source} has malformed scene "
                f"names (e.g. {bad[0]!r}); expected 'scene-NNNN'"
            )
    for a, b in (("train", "val"), ("train", "test"), ("val", "test"),
                 ("train_detect", "train_track")):
        if a in splits and b in splits:
            overlap = set(splits[a]) & set(splits[b])
            if overlap:
                raise ValueError(
                    f"nuScenes splits {a!r} and {b!r} from {source} overlap "
                    f"({sorted(overlap)[:3]}...)"
                )


def get_split_scenes(split: str, dataroot: Optional[str] = None) -> List[str]:
    """Scene names for a nuScenes split, devkit-free where possible."""
    vendored = _vendored_splits()
    if split in vendored:
        if split not in ("mini_train", "mini_val"):
            _validate_full(vendored, str(_FULL_JSON))
        return vendored[split]
    try:
        from nuscenes.utils.splits import create_splits_scenes  # type: ignore

        return create_splits_scenes()[split]
    except ImportError:
        pass
    if dataroot is not None:
        splits_path = os.path.join(dataroot, "splits.json")
        if os.path.isfile(splits_path):
            with open(splits_path) as f:
                table = json.load(f)
            if split in table:
                _validate_full(table, splits_path, check_sizes=False)
                return table[split]
    raise RuntimeError(
        f"nuScenes split {split!r} is not vendored in-tree (only the mini "
        f"splits ship verbatim), the nuscenes-devkit is not importable, and "
        f"no {{dataroot}}/splits.json provides it. Run "
        f"`python scripts/make_nuscenes_splits.py --devkit <path-or-auto>` "
        f"once to vendor the full v1.0 split constants, and copy the "
        f"nuscenes_splits_full.json it writes to {_FULL_JSON}."
    )
