"""Model registry, port of `open3dsot_tpu/models/__init__.py`.

Only M2-Track is ported so far; p2b and bat raise NotImplementedError.
"""

from __future__ import annotations


def get_model(name: str):
    name = name.lower()
    if name == "m2track":
        from open3dsot_tpu_torch.models.m2track import M2TrackModel

        return M2TrackModel
    if name in ("p2b", "bat"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet: see ROADMAP.md (matching models, kernels K3-K5)")
    raise ValueError(f"unknown model {name!r}")
