"""Model registry, port of `open3dsot_tpu/models/__init__.py`.

Names are case-insensitive: m2track, p2b, bat (eval only so far).
"""

from __future__ import annotations


def get_model(name: str):
    name = name.lower()
    if name == "m2track":
        from open3dsot_tpu_torch.models.m2track import M2TrackModel

        return M2TrackModel
    if name == "p2b":
        from open3dsot_tpu_torch.models.p2b import P2BModel

        return P2BModel
    if name == "bat":
        from open3dsot_tpu_torch.models.bat import BATModel

        return BATModel
    raise ValueError(f"unknown model {name!r}")
