"""The port's gather probes (open3dsot_tpu_torch/probes, P1 and P2) against
the JAX package's Pallas probes, run in interpret mode on the CPU.

P1 (scripts/probe_gather.py): `gather_rows` (one index per row, k_take_full
and k_onehot), `gather_elems` (one index per element, k_taa_full) and
`onehot_rowsums` (k_onehot_dbg) on the probe's own A, idx and idx_full, held
exactly. P2 (scripts/probe_pallas_int8.py::kernel, an int8 one-hot product of
bf16 byte planes): `gather_bf16_rows` on the probe's own inputs, max |diff| 0.
On the CPU each wrapper runs its plain version; the CUDA kernels
(csrc/gather_probe.cu) are held to the same plain versions on the card by
chip_smoke.py.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from open3dsot_tpu_torch.models.pointnet import PointnetBackbone
from open3dsot_tpu_torch.probes import gather, gather_bf16

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name):
    """A probe script as a module (importing probe_gather runs its four
    non-interpret calls, which fail on the CPU and print so)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def pg():
    return _script("probe_gather")


def _interpret(pg, kernel, idx_arg):
    """scripts/probe_gather.py::try_one's pallas_call, in interpret mode."""
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((pg.M, pg.C), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(pg.A, idx_arg))


def test_probe_inputs_are_the_scripts(pg):
    a, idx, idx_full = gather.probe_inputs()
    assert (gather.N, gather.C, gather.M) == (pg.N, pg.C, pg.M)
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(pg.A))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(pg.idx)[:, 0])
    np.testing.assert_array_equal(idx_full[0].numpy(), np.asarray(pg.idx_full))
    assert idx.dtype == idx_full.dtype == torch.int32


@pytest.mark.parametrize("kernel, form", [("k_take_full", "ldg"), ("k_take_full", "cp_async"),
                                          ("k_take_full", "bulk"), ("k_onehot", "onehot")])
def test_p1_gather_rows_matches_jax_probe(pg, kernel, form):
    want = _interpret(pg, getattr(pg, kernel), pg.idx)
    a, idx, _ = gather.probe_inputs()
    got = gather.gather_rows(a, idx, form)
    assert got.shape == (1, pg.M, pg.C)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(gather.gather_rows_plain(a, idx)[0].numpy(), want)


def test_p1_gather_elems_matches_jax_take_along_axis(pg):
    want = _interpret(pg, pg.k_taa_full, pg.idx_full)
    a, _, idx_full = gather.probe_inputs()
    np.testing.assert_array_equal(gather.gather_elems(a, idx_full)[0].numpy(), want)


def test_p1_onehot_rowsums_match_jax_dbg(pg):
    want = _interpret(pg, pg.k_onehot_dbg, pg.idx)
    _, idx, _ = gather.probe_inputs()
    got = gather.onehot_rowsums(idx, pg.N, pg.C)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert (got == 1).all()


def test_p1_per_element_indices_differ_per_lane():
    """take_along_axis semantics: each element reads its own row."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    idx_full = torch.from_numpy(rng.integers(0, 16, (2, 5, 8)).astype(np.int32))
    got = gather.gather_elems(a, idx_full)
    for b in range(2):
        for m in range(5):
            for c in range(8):
                assert got[b, m, c] == a[b, idx_full[b, m, c], c]


def test_p1_wrappers_check_and_count():
    a, idx, idx_full = gather.probe_inputs()
    gather.reset_launch_counts()
    for form in gather.FORMS:
        gather.gather_rows(a, idx, form)
    gather.gather_elems(a, idx_full)
    gather.onehot_rowsums(idx, gather.N, gather.C)
    assert set(gather.launch_counts().values()) == {0}  # CPU tensors: the plain versions
    with pytest.raises(ValueError, match="form"):
        gather.gather_rows(a, idx, "tma_gather")
    with pytest.raises(ValueError):
        gather.gather_rows(a[0], idx)
    with pytest.raises(ValueError):
        gather.gather_elems(a, idx_full[..., :4])
    with pytest.raises(ValueError):
        gather.gather_rows(a.to("meta"), idx.to("meta"))


def test_k4_gather_shapes_are_the_bat_forward():
    """K4_GATHERS: the A-form table (N, C1) and rows S x K of each SA call of a
    BAT forward at cfgs/BAT_Car.yaml (template 512, search 1024 points; the
    backbone's layers and the 64-proposal, 16-neighbour vote layer)."""
    want = []
    for cloud, n in (("template", 512), ("search", 1024)):
        for i, (mlp, _) in enumerate(PointnetBackbone.SPECS):
            want.append((f"{cloud} SA{i}", n, mlp[0], n // 2, 32))
            n //= 2
    want.append(("vote SA", 128, 256, 64, 16))
    assert list(gather.K4_GATHERS) == want


def _p2_interpret(p8, a, idx):
    """scripts/probe_pallas_int8.py::main's pallas_call, in interpret mode."""
    a_bf = jnp.asarray(a, jnp.bfloat16)
    u16 = jax.lax.bitcast_convert_type(a_bf, jnp.uint16).astype(jnp.uint32)
    a8 = jnp.concatenate([(u16 >> 8).astype(jnp.uint8), (u16 & 0xFF).astype(jnp.uint8)],
                         axis=-1).astype(jnp.int8)
    n, c1, ts, k = p8.N, p8.C1, p8.TS, p8.K
    return np.asarray(pl.pallas_call(
        p8.kernel, out_shape=jax.ShapeDtypeStruct((1, ts * k, c1), jnp.float32), grid=(1,),
        in_specs=[pl.BlockSpec((1, ts, k), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, n, 2 * c1), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, ts * k, c1), lambda b: (b, 0, 0), memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(idx), a8)), np.asarray(a_bf, np.float32)


def test_p2_matches_jax_probe_exactly():
    p8 = _script("probe_pallas_int8")
    a, a_bf, idx = gather_bf16.probe_inputs()
    assert (gather_bf16.N, gather_bf16.C1, gather_bf16.TS, gather_bf16.K) == (p8.N, p8.C1, p8.TS,
                                                                              p8.K)
    want, jax_bf = _p2_interpret(p8, a.numpy(), idx.numpy())
    np.testing.assert_array_equal(a_bf.float().numpy(), jax_bf)  # the same bf16 rounding
    got = gather_bf16.gather_bf16_rows(a_bf, idx)
    assert got.dtype == torch.float32 and got.shape == (1, p8.TS * p8.K, p8.C1)
    assert np.abs(got.numpy() - want).max() == 0.0
    # the widened rows are the bf16 values, not the f32 ones they came from
    assert not np.array_equal(got.numpy(), a.numpy()[0][idx.numpy()[0].reshape(-1)][None])


def test_p2_wrapper_checks_and_counts():
    _, a_bf, idx = gather_bf16.probe_inputs()
    gather_bf16.reset_launch_counts()
    gather_bf16.gather_bf16_rows(a_bf, idx)
    assert gather_bf16.gather_bf16_rows.launches == 0
    with pytest.raises(ValueError):
        gather_bf16.gather_bf16_rows(a_bf, idx[0])


def test_probe_runs_check_every_form_on_cpu_tensors():
    """The probes' own runs (their entry points and chip_smoke.py's phase 14
    call them with card timers) at a small shape on CPU tensors: every form
    and the bf16 gather held to their plain versions, one row each."""
    shapes = (("template SA0", 64, 16, 16, 8),)
    stub = lambda fn: (fn(), 0.0)[1]  # noqa: E731
    rows = gather.run(time_fn=stub, device_fn=stub, batches=(2,), shapes=shapes, device="cpu")
    assert [r["what"] for r in rows] == ([f"gather_rows {f}" for f in gather.FORMS]
                                         + ["gather_elems", "onehot_rowsums"]
                                         + [f"gather_rows {f}" for f in gather.FORMS])
    assert all(r["ok"] and r["err"] == 0.0 for r in rows)
    assert rows[-1]["B"] == 2 and rows[-1]["M"] == 16 * 8 and rows[-1]["ops"] > 0
    assert set(gather.fastest_exact(rows, 2)) == set(gather.EXACT_FORMS)
    rows = gather_bf16.run(time_fn=stub, batches=(2,), shapes=shapes, device="cpu")
    assert [r["label"] for r in rows] == ["P2", "template SA0"]
    assert all(r["ok"] for r in rows)


def test_probe_bytes_count_each_table_row_once():
    """A gather's bound counts each table row its indices name once (repeats
    come from L2), each index and each output row: here 3 and 2 distinct rows
    of 5 and 4 indices in two clouds."""
    a = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    idx = torch.tensor([[1, 1, 3, 5, 3], [0, 0, 0, 2, 2]], dtype=torch.int32)
    assert gather.unique_rows(idx) == 3 + 2
    stub = lambda fn: (fn(), 0.0)[1]  # noqa: E731
    rows = []
    orig = gather.k4_inputs
    try:
        gather.k4_inputs = lambda *args, **kw: (a, idx)
        rows = gather.run(time_fn=stub, batches=(2,), shapes=(("t", 6, 4, 5, 1),), device="cpu")
    finally:
        gather.k4_inputs = orig
    want = 4 * ((3 + 2) * 4 + 2 * 5 + 2 * 5 * 4)
    assert [r["nbytes"] for r in rows if r["label"] == "t"] == [want] * len(gather.FORMS)
    _, _, idx_full = gather.probe_inputs()
    p1 = next(r for r in rows if r["what"] == "gather_elems")
    distinct = len(set(idx_full[0, :, 0].tolist()))
    assert p1["nbytes"] == 4 * (distinct * gather.C + 2 * gather.M * gather.C)


def test_fps_floor_takes_k3s_block_and_needs_the_card():
    from open3dsot_tpu_torch.ops.sampling import fps_block
    from open3dsot_tpu_torch.probes import fps_floor

    ns = (40, 256, 512, 1000, 1024, 4096)
    # v1: the block K3 had before its redesign, one point a thread up to 1024
    assert [fps_floor.design_threads(1, n) for n in ns] == [64, 256, 512, 1024, 1024, 1024]
    # v2: K3's block as the wrapper chooses it
    assert [fps_floor.design_threads(2, n) for n in ns] == [fps_block(n)[0] for n in ns]
    for design in fps_floor.DESIGNS:
        with pytest.raises(ValueError, match="CUDA"):
            fps_floor.fps_chain_floor(511, 1024, torch.empty(1), design=design)
    with pytest.raises(ValueError, match="design"):
        fps_floor.fps_chain_floor(511, 1024, torch.empty(1), design=3)
    assert fps_floor.fps_chain_floor.launches == 0
