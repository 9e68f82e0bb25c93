"""Profiling and roofline reporting.

The reference has no tracing/profiling of any kind (SURVEY.md §5).  Here:
- `trace(path)`: context manager around `jax.profiler` for full XLA traces
  viewable in Perfetto/TensorBoard.
- `measure(fn, *args)`: wall time of a jitted callable.
- `roofline_report(...)`: achieved vs. published peak memory bandwidth
  and FLOP rate for a measured op on the current device.

Peaks are the vendor's published numbers, keyed by `device_kind`; a
device that is not in the table is an error, not a default.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

# device_kind -> (HBM GB/s, f32 TFLOP/s outside the tensor cores).
# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 (dense);
# both assume the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 67.0),
}


@contextlib.contextmanager
def trace(path: str):
    """Capture a jax.profiler trace around a block."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


def measure(fn, *args, iters: int = 30, warmup: int = 3) -> float:
    """Mean wall time per call (seconds) for a jitted callable."""
    import jax

    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@dataclass(frozen=True)
class Roofline:
    seconds: float
    bytes_accessed: int
    flops: int
    achieved_gbps: float
    achieved_tflops: float
    device_kind: str
    frac_hbm_peak: float
    frac_flops_peak: float

    def __str__(self) -> str:
        return (
            f"{self.seconds*1e3:.3f} ms | {self.achieved_gbps:.1f} GB/s"
            f" | {self.achieved_tflops:.2f} TFLOP/s"
            f" | {self.frac_hbm_peak*100:.0f}% of {self.device_kind}"
            f" HBM peak, {self.frac_flops_peak*100:.1f}% of f32 FLOP peak"
        )


def roofline_report(
    seconds: float, bytes_accessed: int, flops: int,
    device_kind: str | None = None,
) -> Roofline:
    """Achieved rates against `PEAKS[device_kind]` (default: the kind of
    JAX's first device).  Raises KeyError for a device not in PEAKS."""
    import jax

    kind = device_kind or jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    peak_bw, peak_fl = PEAKS[kind]
    gbps = bytes_accessed / seconds / 1e9
    tflops = flops / seconds / 1e12
    return Roofline(
        seconds, bytes_accessed, flops, gbps, tflops, kind,
        gbps / peak_bw, tflops / peak_fl,
    )
