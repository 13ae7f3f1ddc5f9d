"""P1: the row-gather forms on the card, port of `scripts/probe_gather.py`.

On the TPU the probe asked which in-kernel gathers Mosaic lowers (`k_take_full`,
`k_taa_full`, `k_onehot`, and `k_onehot_dbg`'s row sums). Here each form is a
kernel of `csrc/gather_probe.cu` (the design note is there), held against its
plain version and timed at P1's own shape and at the gather shapes of K4's
seven calls in a BAT forward, so that K4 (csrc/sa_fused.cu) gathers its A-form
rows in the fastest exact form:

  `gather_rows(a, idx, form)`   out[b, m] = a[b, idx[b, m]], form in FORMS:
                                "ldg", "cp_async", "bulk" (exact) and "onehot"
                                (TF32 hi + lo on the tensor cores: allclose);
  `gather_elems(a, idx_full)`   out[b, m, c] = a[b, idx_full[b, m, c], c];
  `onehot_rowsums(idx, n, c)`   the row sums of the one-hot (B, M, n), as (B, M, c).

Each wrapper runs its plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises; launches are counted (`gather_rows.launches`,
by form). Indices must lie in [0, N) for the plain versions; the kernels give
NaN rows (zero rows in the one-hot form) outside it.

    python -m open3dsot_tpu_torch.probes.gather    # needs a CUDA device
"""

from __future__ import annotations

import statistics
import sys
from typing import Callable, Optional

import numpy as np
import torch

from open3dsot_tpu_torch.ops._launch import check, on_cuda, raise_on, stream_of

FORMS = ("ldg", "cp_async", "bulk", "onehot")
EXACT_FORMS = FORMS[:3]
N, C, M = 512, 128, 256  # scripts/probe_gather.py: A (N, C), idx (M, 1)
# K4's gathers in one BAT forward at cfgs/BAT_Car.yaml: (label, N, C1, S, K),
# the A-form table (B, N, C1) and its B * S * K rows (csrc/sa_fused.cu)
K4_GATHERS = (("template SA0", 512, 64, 256, 32), ("template SA1", 256, 128, 128, 32),
              ("template SA2", 128, 256, 64, 32), ("search SA0", 1024, 64, 512, 32),
              ("search SA1", 512, 128, 256, 32), ("search SA2", 256, 256, 128, 32),
              ("vote SA", 128, 256, 64, 16))
# the one-hot's hi + lo keeps about 21 of the 24 bits of a value
ONEHOT_RTOL = 1e-5
ONEHOT_ATOL = 1e-6
_ERRORS = {-1: "B, N, M, C or form not accepted", -2: "C is not a multiple of 4"}


# --- plain versions ----------------------------------------------------------

def gather_rows_plain(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B, N, C), idx (B, M) in [0, N) -> a[b, idx[b]] (B, M, C)."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx.long()]


def gather_elems_plain(a: torch.Tensor, idx_full: torch.Tensor) -> torch.Tensor:
    """a (B, N, C), idx_full (B, M, C) -> out[b, m, c] = a[b, idx_full[b, m, c], c]."""
    return torch.gather(a, 1, idx_full.long())


def onehot_rowsums_plain(idx: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """The row sums of the one-hot (B, M, n) of idx, broadcast to (B, M, c)."""
    cols = torch.arange(n, device=idx.device)
    sums = (idx.long()[..., None] == cols).float().sum(-1, keepdim=True)
    return sums.expand(*idx.shape, c).contiguous()


# --- kernel wrappers -----------------------------------------------------------

def _lib():
    from open3dsot_tpu_torch.ops._build import load_library

    return load_library("gather_probe").lib


def _check_rows(a: torch.Tensor, idx: torch.Tensor, idx_dims: int):
    if a.dim() != 3 or idx.dim() != idx_dims or idx.shape[0] != a.shape[0]:
        raise ValueError(f"a (B, N, C) and idx with {idx_dims} dims expected, got "
                         f"{tuple(a.shape)} and {tuple(idx.shape)}")


def gather_rows(a: torch.Tensor, idx: torch.Tensor, form: str = "ldg") -> torch.Tensor:
    """P1, one index per row: a (B, N, C) f32, idx (B, M) int32 -> (B, M, C)."""
    _check_rows(a, idx, 2)
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if not on_cuda(a):
        return gather_rows_plain(a, idx)
    B, n, c = a.shape
    check("a", a, a.device)
    check("idx", idx, a.device, dtype=torch.int32)
    out = torch.empty(B, idx.shape[1], c, device=a.device)
    rc = _lib().gather_rows(a.data_ptr(), idx.data_ptr(), out.data_ptr(), B, n, idx.shape[1], c,
                            FORMS.index(form), stream_of(a))
    raise_on(rc, f"P1 gather_rows ({form})", _ERRORS)
    gather_rows.launches[form] += 1
    return out


def gather_elems(a: torch.Tensor, idx_full: torch.Tensor) -> torch.Tensor:
    """P1, one index per element (k_taa_full): idx_full (B, M, C) int32 -> (B, M, C)."""
    _check_rows(a, idx_full, 3)
    if idx_full.shape[2] != a.shape[2]:
        raise ValueError(f"idx_full must be (B, M, {a.shape[2]}), got {tuple(idx_full.shape)}")
    if not on_cuda(a):
        return gather_elems_plain(a, idx_full)
    B, n, c = a.shape
    check("a", a, a.device)
    check("idx_full", idx_full, a.device, dtype=torch.int32)
    out = torch.empty(B, idx_full.shape[1], c, device=a.device)
    rc = _lib().gather_elems(a.data_ptr(), idx_full.data_ptr(), out.data_ptr(), B, n,
                             idx_full.shape[1], c, stream_of(a))
    raise_on(rc, "P1 gather_elems", _ERRORS)
    gather_elems.launches += 1
    return out


def onehot_rowsums(idx: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """P1's k_onehot_dbg: the one-hot (B, M, n) of idx (B, M) times a table of
    ones on the tensor cores -> (B, M, c), every row its one-hot's row sum."""
    if idx.dim() != 2:
        raise ValueError(f"idx must be (B, M), got {tuple(idx.shape)}")
    if not on_cuda(idx):
        return onehot_rowsums_plain(idx, n, c)
    check("idx", idx, idx.device, dtype=torch.int32)
    B, m = idx.shape
    out = torch.empty(B, m, c, device=idx.device)
    rc = _lib().onehot_rowsums(idx.data_ptr(), out.data_ptr(), B, n, m, c, stream_of(idx))
    raise_on(rc, "P1 onehot_rowsums", _ERRORS)
    onehot_rowsums.launches += 1
    return out


gather_rows.launches = dict.fromkeys(FORMS, 0)
gather_elems.launches = 0
onehot_rowsums.launches = 0


def reset_launch_counts() -> None:
    gather_rows.launches = dict.fromkeys(FORMS, 0)
    gather_elems.launches = 0
    onehot_rowsums.launches = 0


def launch_counts() -> dict:
    return {**{f"gather_rows {f}": v for f, v in gather_rows.launches.items()},
            "gather_elems": gather_elems.launches, "onehot_rowsums": onehot_rowsums.launches}


# --- the probe -------------------------------------------------------------------

def probe_inputs(device="cpu"):
    """scripts/probe_gather.py's A (N, C), idx (M, 1) and idx_full (M, C) from
    np.random.default_rng(0), as (1, N, C), (1, M) and (1, M, C)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(M, 1)).astype(np.int32)
    idx_full = np.broadcast_to(idx, (M, C)).copy()
    return tuple(torch.from_numpy(x)[None].to(device) for x in (a, idx[:, 0], idx_full))


def k4_inputs(n: int, c: int, rows: int, B: int, seed: int, device="cpu"):
    """A table (B, n, c) and B x rows indices in [0, n), from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(B, n, c, device=device, generator=gen)
    idx = torch.randint(0, n, (B, rows), device=device, generator=gen, dtype=torch.int32)
    return a, idx


def unique_rows(idx: torch.Tensor) -> int:
    """Table rows that idx (B, M) reads, counted once per cloud."""
    return sum(int(torch.unique(row).numel()) for row in idx.reshape(idx.shape[0], -1))


def event_ms(fn: Callable, iters: int = 20, repeats: int = 5) -> float:
    """Median over repeats of the mean time of `iters` back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def sync(t: torch.Tensor) -> None:
    """Wait for the device where t lies (nothing to wait for on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _compare(got: torch.Tensor, want: torch.Tensor, exact: bool):
    err = (got - want).abs().max().item()
    ok = err == 0.0 if exact else torch.allclose(got, want, rtol=ONEHOT_RTOL, atol=ONEHOT_ATOL)
    return bool(ok and torch.isfinite(got).all()), err


def run(time_fn: Optional[Callable] = None, device_fn: Optional[Callable] = None,
        batches=(1, 16), shapes=K4_GATHERS, device: str = "cuda") -> list:
    """Every form at P1's shape (with the per-element gather and the one-hot's
    row sums) and at K4's gather shapes for each batch size: correct or not,
    max |diff|, and times: `time_fn` (default `event_ms`) of the kernel, its
    plain version and torch.gather; `device_fn` (optional) the kernel's
    device time. Returns one dict per line printed."""
    time_fn = time_fn or event_ms
    rows = []

    def one(what, label, kernel, plain, library, exact, nbytes, ops):
        got, want = kernel(), plain()
        sync(got)
        ok, err = _compare(got, want, exact)
        B, m, c = want.shape
        rows.append(dict(what=what, label=label, B=B, N=n_of[label], C=c, M=m, ok=ok, err=err,
                         ms=time_fn(kernel), plain_ms=time_fn(plain),
                         dev_ms=device_fn(kernel) if device_fn else None,
                         library_ms=None if library is None else time_fn(library),
                         nbytes=nbytes, ops=ops))

    def forms(label, a, idx):
        B, n, c = a.shape
        m = idx.shape[1]
        wide = idx.long()[..., None].expand(B, m, c)
        # bytes: each table row that idx names read once (repeats come from L2),
        # each index read and each output row written once; the one-hot form's
        # two TF32 products count 2 x 2 x M x N x C operations
        nbytes = 4 * (unique_rows(idx) * c + B * m + B * m * c)
        for form in FORMS:
            one(f"gather_rows {form}", label, lambda: gather_rows(a, idx, form),
                lambda: gather_rows_plain(a, idx), lambda: torch.gather(a, 1, wide),
                form in EXACT_FORMS, nbytes, 4 * B * m * n * c if form == "onehot" else 0)

    n_of = {"P1": N, **{label: n for label, n, _, _, _ in shapes}}
    a, idx, idx_full = probe_inputs(device)
    forms("P1", a, idx)
    # bytes: each table element that idx_full names, its indices and the output
    elems = int(torch.unique(idx_full.long() * C + torch.arange(C, device=device)).numel())
    one("gather_elems", "P1", lambda: gather_elems(a, idx_full),
        lambda: gather_elems_plain(a, idx_full), lambda: torch.gather(a, 1, idx_full.long()),
        True, 4 * (elems + 2 * M * C), 0)
    one("onehot_rowsums", "P1", lambda: onehot_rowsums(idx, N, C),
        lambda: onehot_rowsums_plain(idx, N, C), None, True, 4 * (M + M * C), 4 * M * N * C)
    for B in batches:
        for i, (label, n, c, s, k) in enumerate(shapes):
            forms(label, *k4_inputs(n, c, s * k, B, seed=i, device=device))
    return rows


def fastest_exact(rows: list, B: int) -> dict:
    """Time of each exact form summed over K4's gather shapes at batch B: device
    time where measured, else events."""
    tot = {}
    for r in rows:
        form = r["what"].split()[-1]
        if r["label"] != "P1" and r["B"] == B and form in EXACT_FORMS:
            t = r["dev_ms"] if r["dev_ms"] is not None else r["ms"]
            tot[form] = tot.get(form, 0.0) + t
    return tot


def line(r: dict) -> str:
    dev = "" if r["dev_ms"] is None else f", device {r['dev_ms']:.4f} ms"
    lib = "" if r["library_ms"] is None else f"; torch.gather {r['library_ms']:.4f} ms"
    return (f"{r['what']} {r['label']} B={r['B']} N={r['N']} C={r['C']} M={r['M']}: "
            f"correct={r['ok']} max|diff| {r['err']:.3e}; {r['ms']:.4f} ms{dev}; plain "
            f"{r['plain_ms']:.4f} ms{lib}")


def main() -> int:
    if not torch.cuda.is_available():
        print("P1 gather probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"backend: {torch.cuda.get_device_name(0)}", flush=True)
    rows = run()
    for r in rows:
        print(line(r), flush=True)
    for B in (1, 16):
        tot = fastest_exact(rows, B)
        print(f"K4's seven gathers at B={B}: " + ", ".join(f"{f} {t:.4f} ms" for f, t in tot.items())
              + f"; fastest exact form: {min(tot, key=tot.get)}", flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
