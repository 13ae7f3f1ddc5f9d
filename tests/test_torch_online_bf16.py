"""bf16 online serving (tracking/online.py, tracking/serving_export.py) and
the online slot pool split over several devices (`devices=`), on the CPU,
where the advance runs eagerly and the kernels' plain versions (the
weights, data and helpers of tests/test_torch_online.py).

Tolerances: within the port bit for bit, since the online step is the scan
step on the same rows: a bf16 model's online trajectories equal its scan
tracker's at the same B and P, a loaded bf16 bundle equals the live
tracker, and a pool split over [cpu, cpu] equals two unsplit trackers of
half the slots. Against JAX's online tracker with a bf16 model, the first
step within 5e-2 (tests/test_torch_bf16.py's scan tolerance). The two bf16
paths sum in other orders and their bf16 roundings part early; whole
trajectories are not held, as argmax flips compound. For BAT the heads
predict one offset with equal objectness for every proposal
(tests/test_torch_scan_matching.py's `offset`), so that the argmax over
the proposals takes the same one on both sides and the step holds the
backbone's and the votes' bf16 arithmetic.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from open3dsot_tpu.data import get_dataset as j_get_dataset
from open3dsot_tpu.tracking import online as jon
from open3dsot_tpu_torch.data import get_dataset
from open3dsot_tpu_torch.tracking import online as pon
from open3dsot_tpu_torch.tracking.serving_export import load_serving_bundle, save_serving_bundle
from tests.test_torch_online import _online, _run, _scan
from tests.test_torch_scan_matching import FIRST_CROP
from tests.test_torch_scan_matching import MAX_POINTS as MATCH_P
from tests.test_torch_scan_matching import _pair as match_pair
from tests.test_torch_scan_matching import numpy_crop  # noqa: F401  (autouse)
from tests.test_torch_scan_tracker import MAX_POINTS as M2_P
from tests.test_torch_scan_tracker import _pair as m2_pair


def _bf16_setup(family: str, n: int = 3, bf16: bool = True, **over):
    """(JAX model, variables, JAX config), port model, port config, port
    tracklets, JAX tracklets, match: the model of `family` made under
    `bf16: true`."""
    if family == "m2":
        (jm, variables, jcfg), (port, pcfg) = m2_pair(bf16=bf16, **over)
    else:
        (jm, variables, jcfg), (port, pcfg) = match_pair(family, bf16=bf16, **over)
    seqs = [get_dataset(pcfg, "test", "test")[i] for i in range(n)]
    jseqs = [j_get_dataset(jcfg, "test", "test")[i] for i in range(n)]
    return (jm, variables, jcfg), port, pcfg, seqs, jseqs, family != "m2"


@pytest.mark.parametrize("family", ["m2", "bat", "p2b"])
def test_bf16_online_equals_the_bf16_scan_tracker(family):
    _, port, pcfg, seqs, _, match = _bf16_setup(family)
    online = _online(port, pcfg, match, len(seqs))
    assert online.compute_mode == "bfloat16"
    want = _scan(port, pcfg, match).track_batch(seqs)
    for g, w in zip(_run(online, seqs, match), want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("family", ["m2", "bat"])
def test_bf16_online_first_step_matches_jax_online(family):
    """The first step of every stream against JAX's online tracker with the
    same bf16 model; the control: the port's f32 tracker on the same
    weights gives other boxes, so the bf16 path did compute in bf16."""
    over = {} if family == "m2" else dict(offset=(0.3, 0.1, 0.05, 2.0))
    (jm, variables, jcfg), port, pcfg, seqs, jseqs, match = _bf16_setup(family, n=2, **over)
    if match:
        jt = jon.OnlineMatchTracker(jm, variables, jcfg, max_streams=2, max_points=MATCH_P,
                                    first_crop_points=FIRST_CROP)
    else:
        jt = jon.OnlineM2Tracker(jm, variables, jcfg, max_streams=2, max_points=M2_P)
    want = _run(jt, [s[:2] for s in jseqs], match)
    got = _run(_online(port, pcfg, match, 2), [s[:2] for s in seqs], match)
    _, f32, f32_cfg, _, _, _ = _bf16_setup(family, n=2, bf16=False, **over)
    control = _run(_online(f32, f32_cfg, match, 2), [s[:2] for s in seqs], match)
    for g, w, c in zip(got, want, control):
        np.testing.assert_allclose(g, w, atol=5e-2)
        assert not np.array_equal(g, c)


@pytest.mark.parametrize("family", ["m2", "bat"])
def test_bf16_bundle_round_trip(family, tmp_path):
    """A bf16 tracker's bundle records its mode and serves the live
    tracker's trajectories bit for bit, with no model built."""
    _, port, pcfg, seqs, _, match = _bf16_setup(family, n=2)
    live = _online(port, pcfg, match, 2)
    want = _run(live, seqs, match)
    save_serving_bundle(live, tmp_path / "bundle")
    meta = json.loads((tmp_path / "bundle" / "meta.json").read_text())
    assert meta["compute_mode"] == "bfloat16"
    served = load_serving_bundle(tmp_path / "bundle")
    assert served.model is None and served.compute_mode == "bfloat16"
    for g, w in zip(_run(served, seqs, match), want):
        np.testing.assert_array_equal(g, w)


# --- the slot axis over several devices ----------------------------------------------

def _on_devices(port, pcfg, match: bool, B: int, devices: list):
    """make_online_tracker with `devices`, at _online's sizes."""
    kw = dict(max_points=MATCH_P, first_crop_points=FIRST_CROP) if match else \
        dict(max_points=M2_P)
    return pon.make_online_tracker(port, pcfg, max_streams=B, devices=devices, **kw)


@pytest.mark.parametrize("family", ["m2", "bat"])
def test_split_pool_equals_unsplit_trackers_of_half_the_slots(family):
    """max_streams 4 over devices [cpu, cpu]: slots 0-1 are the first
    sub-pool, 2-3 the second, each its own tracker of 2 slots; three
    streams in slots 0, 1 and 2 give what two trackers of 2 slots give."""
    _, port, pcfg, seqs, _, match = _bf16_setup(family, bf16=False)
    split = _on_devices(port, pcfg, match, 4, ["cpu", "cpu"])
    assert isinstance(split, pon.SplitOnlineTracker) and len(split.parts) == 2
    assert all(p.max_streams == 2 for p in split.parts)
    got = _run(split, seqs, match, slots=[0, 1, 2])
    want = _run(_online(port, pcfg, match, 2), seqs[:2], match) + \
        _run(_online(port, pcfg, match, 2), seqs[2:], match)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert split.free_slots() == [3]
    np.testing.assert_array_equal(split.current_box(2), got[2][-1])
    split.stop(1)
    assert split.free_slots() == [1, 3]


def test_split_pool_refusals(tmp_path):
    """The slot count must divide by the device count, as the mesh's in
    JAX; a split tracker is not exported (JAX refuses a sharded one); a
    slot outside the pool is refused with the pool's size."""
    _, port, pcfg, _, _, _ = _bf16_setup("m2", n=1, bf16=False)
    with pytest.raises(ValueError, match="max_streams 3 does not divide over 2 devices"):
        _on_devices(port, pcfg, False, 3, ["cpu", "cpu"])
    split = _on_devices(port, pcfg, False, 2, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="split over several devices cannot be exported"):
        save_serving_bundle(split, tmp_path / "bundle")
    with pytest.raises(ValueError, match=r"slot must be an int in \[0, 2\)"):
        split.reset(2, np.zeros((4, 3), np.float32), None)
    # one device puts the tracker there, unsplit
    assert type(_on_devices(port, pcfg, False, 2, ["cpu"])) is pon.OnlineM2Tracker
