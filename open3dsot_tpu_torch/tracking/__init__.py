"""Tracking paths: the host loop (eval.py), the batched on-device scan
trackers (scan_tracker.py, scan_matching.py), and the online serving API
(online.py) with its serving bundles (serving_export.py)."""

from open3dsot_tpu_torch.tracking.online import (  # noqa: F401
    OnlineM2Tracker,
    OnlineMatchTracker,
    make_online_tracker,
)
from open3dsot_tpu_torch.tracking.scan_matching import (  # noqa: F401
    MatchScanTracker,
    evaluate_dataset_scan_matching,
)
from open3dsot_tpu_torch.tracking.scan_tracker import (  # noqa: F401
    M2ScanTracker,
    evaluate_dataset_scan,
)
from open3dsot_tpu_torch.tracking.serving_export import (  # noqa: F401
    load_serving_bundle,
    save_serving_bundle,
)
