"""Serving bundles of the port's online trackers
(tracking/serving_export.py) on the CPU, where the exported programs call
the kernels' operators' plain versions.

A loaded bundle, built from the exported programs and meta.json alone with
no model constructed, gives the live tracker's trajectories bit for bit
(the programs run the same aten ops on the same weights); the operators'
fake implementations give their plain outputs' shapes and dtypes exactly.
"""

from __future__ import annotations

import inspect
import json
import re
import shutil

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from open3dsot_tpu_torch import models
from open3dsot_tpu_torch.models.pointnet import _FoldCache, folds_as_buffers, weights_key
from open3dsot_tpu_torch.ops import chain_fused, sa_fused, sampling
from open3dsot_tpu_torch.tracking.serving_export import (
    FORMAT_VERSION,
    load_serving_bundle,
    save_serving_bundle,
)
from tests.test_torch_online import _online, _run, _setup
from tests.test_torch_scan_matching import numpy_crop  # noqa: F401  (autouse)

OPS = {  # the kernels' operators and their launches in one online step
    "K1": torch.ops.open3dsot.fused_pointnet_encoder.default,
    "K2": torch.ops.open3dsot.fused_seg_head.default,
    "K3": torch.ops.open3dsot.furthest_point_sample.default,
    "K4": torch.ops.open3dsot.fused_sa_apply.default,
}
STEP_OPS = {"m2": {"K1": 3, "K2": 1}, "bat": {"K3": 2, "K4": 7}}


CASES = (("m2", None), ("m2", "int16"), ("bat", None))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(case, codec) -> (bundle path, the live tracker's trajectories,
    tracklets, match, the live tracker), each bundle saved at first use."""
    saved = {}

    def get(case, codec=None):
        if (case, codec) not in saved:
            _, port, pcfg, seqs, _, match = _setup(case, n=2)
            live = _online(port, pcfg, match, 2, transfer_dtype=codec)
            want = _run(live, seqs, match)
            path = tmp_path_factory.mktemp(f"{case}-{codec}") / "bundle"
            save_serving_bundle(live, path)
            saved[case, codec] = (path, want, seqs, match, live)
        return saved[case, codec]

    return get


@pytest.mark.parametrize("case, codec", CASES)
def test_bundle_round_trip(bundles, case, codec):
    path, want, seqs, match, live = bundles(case, codec)
    served = load_serving_bundle(path)
    assert served.model is None and type(served) is type(live)
    assert served.transfer_dtype == codec and served.device.type == "cpu"
    if match:
        assert served.first_crop_points == live.first_crop_points
    for g, w in zip(_run(served, seqs, match), want):
        np.testing.assert_array_equal(g, w)


def test_meta_is_self_describing(bundles):
    for case, codec in CASES:
        path, _, _, match, live = bundles(case, codec)
        meta = json.loads((path / "meta.json").read_text())
        assert meta["format_version"] == FORMAT_VERSION
        assert meta["family"] == ("match" if match else "m2track")
        assert (meta["max_streams"], meta["max_points"]) == (2, live.max_points)
        assert meta["transfer_dtype"] == codec and meta["device"] == "cpu"
        assert meta["torch_version"] == torch.__version__
        assert meta["up_axis"] == [0.0, 0.0, 1.0]
        assert meta["state_shapes"] == {k: [list(v.shape), str(v.dtype)[len("torch."):]]
                                        for k, v in live._state.items()}
        if match:
            assert meta["first_crop_points"] == live.first_crop_points
            assert meta["model_bb_scale"] == live.config.model_bb_scale
            assert meta["model_bb_offset"] == live.config.model_bb_offset
        assert sorted(p.name for p in path.iterdir()) == ["advance.pt2", "meta.json"]


def _edited_copy(bundles, tmp_path, **meta_over):
    path = tmp_path / "bundle"
    shutil.copytree(bundles("m2")[0], path)
    meta = json.loads((path / "meta.json").read_text())
    meta.update(meta_over)
    (path / "meta.json").write_text(json.dumps(meta))
    return path


def test_wrong_format_version_refused(bundles, tmp_path):
    with pytest.raises(ValueError, match="bundle format 99"):
        load_serving_bundle(_edited_copy(bundles, tmp_path, format_version=99))


def test_cuda_bundle_refused_without_a_card(bundles, tmp_path, monkeypatch):
    """A bundle exported on the card does not run on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported for device 'cuda'"):
        load_serving_bundle(_edited_copy(bundles, tmp_path, device="cuda"))


def test_unloadable_program_names_the_torch_versions(bundles, tmp_path):
    path = _edited_copy(bundles, tmp_path, torch_version="0.0.1")
    (path / "advance.pt2").write_bytes(b"not a program")
    want = re.escape(f"torch 0.0.1, with torch {torch.__version__}")
    with pytest.raises(RuntimeError, match=want):
        load_serving_bundle(path)


def test_loading_builds_no_model(bundles, monkeypatch):
    """No nn.Module of the port's models package is constructed by a load
    or a step: the programs carry the advance and its weights."""
    built = []
    for name in ("bat", "layers", "m2track", "matching_base", "p2b", "pointnet", "rpn", "xcorr"):
        module = __import__(f"{models.__name__}.{name}", fromlist=["_"])
        for cls in vars(module).values():
            if (inspect.isclass(cls) and issubclass(cls, nn.Module)
                    and cls.__module__ == module.__name__):
                monkeypatch.setattr(cls, "__init__",
                                    lambda self, *a, _c=cls, **k: built.append(_c))
    path, want, seqs, match, _ = bundles("bat")
    got = _run(load_serving_bundle(path), seqs, match)
    assert built == []
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("case", ["m2", "bat"])
def test_programs_carry_their_weights_and_call_the_kernels(bundles, case):
    """The program holds the folded and packed weights as buffers of its own
    (no lifted constants, no fold traced) and calls the kernels' operators
    as often as a step launches them."""
    program = torch.export.load(bundles(case)[0] / "advance.pt2")
    assert not program.constants
    assert any(".folded_" in k for k in program.state_dict)
    calls = {k: sum(n.target is op for n in program.graph.nodes) for k, op in OPS.items()}
    assert calls == {k: STEP_OPS[case].get(k, 0) for k in OPS}


def test_a_failed_fold_leaves_the_net_as_it_was(monkeypatch):
    """A fold cache whose buffers fail to register partway through leaves
    none of them behind: the net's state_dict and weights_key are unchanged."""
    net = _setup("bat", n=1)[1].net
    keys, key = list(net.state_dict()), weights_key(net)
    cache = next(m for m in net.modules() if isinstance(m, _FoldCache))
    register = cache.register_buffer

    def register_one(name, t):
        if name != "folded_0":
            raise RuntimeError("out of memory")
        register(name, t)

    monkeypatch.setattr(cache, "register_buffer", register_one)
    with pytest.raises(RuntimeError, match="out of memory"), folds_as_buffers(net):
        pass
    assert list(net.state_dict()) == keys and weights_key(net) == key
    assert all(m._fold_buffers is None for m in net.modules() if isinstance(m, _FoldCache))


def test_save_refuses_a_loaded_tracker(bundles, tmp_path):
    with pytest.raises(ValueError, match="no model"):
        save_serving_bundle(load_serving_bundle(bundles("m2")[0]), tmp_path / "again")


def _chain(widths, split=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    layers = [(torch.randn(a, b, generator=g) * 0.2, torch.randn(b, generator=g) * 0.1)
              for a, b in zip(widths[:-1], widths[1:])]
    return chain_fused.FoldedChain(layers, split=split)


def _fake_case(kernel: str, shape: int):
    """(operator, its arguments) at one of two shapes."""
    g = torch.Generator().manual_seed(shape)
    B, N = ((2, 40), (3, 17))[shape]
    if kernel == "K1":
        chain = _chain([5, 16, 8, 24])
        return OPS["K1"], (torch.randn(B, N, 5, generator=g), chain.packed, chain.weights,
                           chain.biases, chain.packed_widths, (1, -1)[shape])
    if kernel == "K2":
        chain = _chain([8 + 24, 16, 3], split=8)
        return OPS["K2"], (torch.randn(B, N, 8, generator=g), torch.randn(B, 24, generator=g),
                           chain.packed, chain.w_pool, chain.weights, chain.biases,
                           chain.packed_widths)
    if kernel == "K3":
        return OPS["K3"], (torch.randn(B, N, 3, generator=g), (8, N)[shape], -1, -1)
    C = (0, 4)[shape]
    layers = [t for w, b in _chain([3 + C, 8, 8, 16]).layers for t in (w, b)]
    feats = torch.randn(B, N, C, generator=g) if C else None
    return OPS["K4"], (torch.randn(B, N, 3, generator=g), feats,
                       torch.randn(B, 6, 3, generator=g), layers, [], 0.5, bool(shape), True,
                       8, -1)


@pytest.mark.parametrize("shape", [0, 1])
@pytest.mark.parametrize("kernel", list(OPS))
def test_fake_shapes_equal_the_plain_outputs(kernel, shape):
    op, args = _fake_case(kernel, shape)
    plain = op(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                     [mode.from_tensor(t) for t in a] if isinstance(a, list) and a
                     and isinstance(a[0], torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    plain, fake = (o if isinstance(o, tuple) else (o,) for o in (plain, fake))
    assert [(tuple(p.shape), p.dtype) for p in plain] == [(tuple(f.shape), f.dtype) for f in fake]


CUDA_FUNCTIONS = {"K1": (chain_fused, "_k1_cuda"), "K2": (chain_fused, "_k2_cuda"),
                  "K3": (sampling, "_k3_cuda"), "K4": (sa_fused, "_launch")}


@pytest.mark.parametrize("kernel", list(OPS))
def test_wrappers_call_the_operator_for_a_traced_cuda_tensor(kernel, monkeypatch):
    """A wrapper given a traced CUDA tensor (a fake one, as torch.export on
    the card hands it) calls its operator, which a traced program records,
    and does not launch the kernel itself, which it does only for a real
    CUDA tensor."""
    module, name = CUDA_FUNCTIONS[kernel]
    monkeypatch.setattr(module, name, lambda *a, **k: pytest.fail(f"{name} called"))
    g = torch.Generator().manual_seed(0)
    B, N = 2, 40
    mode = FakeTensorMode()

    def card(t):  # a fake tensor on a CUDA device, made without one
        return FakeTensor(mode, t.to("meta"), torch.device("cuda"))

    def on_card(chain):
        return chain.with_tensors([card(t) for t in chain.tensors()])

    xyz = card(torch.randn(B, N, 3, generator=g))
    if kernel == "K1":
        x, chain = card(torch.randn(B, N, 5, generator=g)), on_card(_chain([5, 16, 8, 24]))
        with mode:
            outs = chain_fused.fused_pointnet_encoder(x, chain, tap_at=1)
        want = [(B, N, 8), (B, 24)]
    elif kernel == "K2":
        tap, pooled = card(torch.randn(B, N, 8, generator=g)), card(torch.randn(B, 24, generator=g))
        chain = on_card(_chain([8 + 24, 16, 3], split=8))
        with mode:
            outs = (chain_fused.fused_seg_head(tap, pooled, chain),)
        want = [(B, N, 3)]
    elif kernel == "K3":
        with mode:
            outs = (sampling.furthest_point_sample(xyz, 8),)
        want = [(B, 8)]
    else:
        folded = tuple((card(w), card(b)) for w, b in _chain([3, 8, 8, 16]).layers)
        new_xyz = card(torch.randn(B, 6, 3, generator=g))
        with mode:
            outs = (sa_fused.fused_sa_apply(xyz, None, new_xyz, None, folded, radius=0.5,
                                            normalize_xyz=True, use_xyz=True, nsample=8),)
        want = [(B, 6, 16)]
    assert [tuple(o.shape) for o in outs] == want
    assert all(o.device.type == "cuda" for o in outs)


def test_wrappers_count_no_launch_on_the_cpu():
    """On the CPU the operators run the plain versions: no kernel launches."""
    before = (chain_fused.fused_pointnet_encoder.launches, sampling.furthest_point_sample.launches,
              sa_fused.fused_sa_apply.launches)
    for kernel in OPS:
        op, args = _fake_case(kernel, 0)
        op(*args)
    assert (chain_fused.fused_pointnet_encoder.launches, sampling.furthest_point_sample.launches,
            sa_fused.fused_sa_apply.launches) == before
