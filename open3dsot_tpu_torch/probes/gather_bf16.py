"""P2: an exact gather of bf16 rows widened to f32, port of
`scripts/probe_pallas_int8.py`.

On the TPU the probe gathered bf16 rows as an int8 one-hot product of their
two byte planes and reassembled the bits in the kernel; it had to be exact.
Here the kernel (csrc/gather_probe.cu, `gather_bf16_rows`) loads 8 bf16
values a thread and widens them by a shift: `f32(a_bf)[b, idx]` bit for bit.
The bf16 table is made outside the kernel (`a.to(torch.bfloat16)`), as the
byte planes were made outside the pallas_call.

`gather_bf16_rows` runs its plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises; its launches are counted.

    python -m open3dsot_tpu_torch.probes.gather_bf16    # needs a CUDA device
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

from open3dsot_tpu_torch.ops._launch import check, on_cuda, raise_on, stream_of
from open3dsot_tpu_torch.probes.gather import K4_GATHERS, event_ms, sync, unique_rows

N, C1, TS, K = 1024, 64, 64, 32  # scripts/probe_pallas_int8.py
_ERRORS = {-1: "B, N, M or C not accepted", -2: "C is not a multiple of 8"}


def gather_bf16_rows_plain(a_bf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a_bf (B, N, C) bf16, idx (B, TS, K) in [0, N) -> (B, TS * K, C) f32."""
    B = a_bf.shape[0]
    rows = idx.reshape(B, -1).long()
    return a_bf[torch.arange(B, device=a_bf.device)[:, None], rows].float()


def gather_bf16_rows(a_bf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2: a_bf (B, N, C) bf16, idx (B, TS, K) int32 -> (B, TS * K, C) f32, exact."""
    if a_bf.dim() != 3 or idx.dim() != 3 or idx.shape[0] != a_bf.shape[0]:
        raise ValueError(f"a_bf (B, N, C) and idx (B, TS, K) expected, got {tuple(a_bf.shape)} "
                         f"and {tuple(idx.shape)}")
    if not on_cuda(a_bf):
        return gather_bf16_rows_plain(a_bf, idx)
    from open3dsot_tpu_torch.ops._build import load_library

    B, n, c = a_bf.shape
    m = idx.shape[1] * idx.shape[2]
    check("a_bf", a_bf, a_bf.device, dtype=torch.bfloat16)
    check("idx", idx, a_bf.device, dtype=torch.int32)
    out = torch.empty(B, m, c, device=a_bf.device)
    rc = load_library("gather_probe").lib.gather_bf16_rows(
        a_bf.data_ptr(), idx.data_ptr(), out.data_ptr(), B, n, m, c, stream_of(a_bf))
    raise_on(rc, "P2 gather_bf16_rows", _ERRORS)
    gather_bf16_rows.launches += 1
    return out


gather_bf16_rows.launches = 0


def reset_launch_counts() -> None:
    gather_bf16_rows.launches = 0


def probe_inputs(device="cpu"):
    """scripts/probe_pallas_int8.py's idx (1, TS, K) and a (1, N, C1) from
    np.random.default_rng(0); returns (a f32, a bf16, idx)."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, N, size=(1, TS, K)).astype(np.int32)).to(device)
    a = torch.from_numpy(rng.normal(size=(1, N, C1)).astype(np.float32)).to(device)
    return a, a.to(torch.bfloat16), idx


def run(time_fn: Optional[Callable] = None, device_fn: Optional[Callable] = None,
        batches=(1, 16), shapes=K4_GATHERS, device: str = "cuda") -> list:
    """P2 at its own shape and at K4's gather shapes (bf16 tables): the max
    |diff| from the plain version (must be 0) and the times, as
    probes/gather.py::run gives them."""
    time_fn = time_fn or event_ms
    cases = [("P2", *probe_inputs(device)[1:])]
    for B in batches:
        for i, (label, n, c, s, k) in enumerate(shapes):
            gen = torch.Generator(device=device).manual_seed(100 + i)
            a = torch.randn(B, n, c, device=device, generator=gen).to(torch.bfloat16)
            idx = torch.randint(0, n, (B, s, k), device=device, generator=gen, dtype=torch.int32)
            cases.append((label, a, idx))
    rows = []
    for label, a, idx in cases:
        kernel, plain = (lambda: gather_bf16_rows(a, idx)), (lambda: gather_bf16_rows_plain(a, idx))
        got, want = kernel(), plain()
        sync(got)
        err = (got - want).abs().max().item()
        B, m, c = want.shape
        # the one PyTorch call: torch.gather of the bf16 rows (index built
        # beforehand; the cast to f32 left out)
        gidx = idx.reshape(B, -1).long()[..., None].expand(-1, -1, c)
        library = lambda: torch.gather(a, 1, gidx)  # noqa: E731
        rows.append(dict(what="gather_bf16_rows", label=label, B=B, N=a.shape[1], C=c, M=m,
                         ok=err == 0.0 and bool(torch.isfinite(got).all()), err=err,
                         ms=time_fn(kernel), plain_ms=time_fn(plain),
                         dev_ms=device_fn(kernel) if device_fn else None,
                         library_ms=time_fn(library),
                         nbytes=2 * unique_rows(idx) * c + 4 * B * (m + m * c), ops=0))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("P2 bf16 gather probe: no CUDA device", file=sys.stderr)
        return 1
    _, a_bf, idx = probe_inputs("cuda")
    d = (gather_bf16_rows(a_bf, idx) - gather_bf16_rows_plain(a_bf, idx)).abs().max().item()
    print(f"OK max|diff| = {d}", flush=True)
    return 0 if d == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
