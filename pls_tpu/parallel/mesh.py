"""Device-mesh construction and multi-host initialization.

The canonical PLS mesh has two logical axes (SURVEY.md §2):
  'rows'  — data parallelism over observations: X/Y row shards; the
            contractions XᵀY, XᵀX, Xᵀt, tᵀt all-reduce over this axis.
  'folds' — scenario parallelism over CV folds / bootstrap replicates:
            embarrassingly parallel model fits.

The cards of one GPU host are joined all to all by NVLink, so every
device reaches every other at the same rate and the mesh follows the
algorithm alone: 'rows' carries the per-component all-reduces, 'folds'
carries none (replicates never communicate).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_pls_mesh(
    rows: int | None = None,
    folds: int = 1,
    devices=None,
) -> Mesh:
    """Build a ('rows', 'folds') mesh over the given (default: all) devices.

    If `rows` is None, it is inferred as n_devices // folds.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if rows is None:
        if n % folds:
            raise ValueError(f"{n} devices not divisible by folds={folds}")
        rows = n // folds
    if rows * folds != n:
        raise ValueError(f"rows*folds = {rows * folds} != {n} devices")
    dev_array = np.asarray(devices).reshape(rows, folds)
    return Mesh(dev_array, ("rows", "folds"))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    retries: int = 3,
    retry_delay_sec: float = 5.0,
) -> None:
    """Multi-host bring-up: `jax.distributed.initialize` wrapper with
    bounded retry.

    Pass the coordinator address, process count and process id; nothing
    in a plain GPU host's environment supplies them.  An
    "already initialized" condition is a silent no-op; a coordinator
    connection failure (workers racing the coordinator's startup) is
    retried `retries` times with `retry_delay_sec` backoff, then
    re-raised — failing LOUDLY rather than continuing single-process
    with a mesh the caller believes is multi-host.

    Validated cross-process by tests/test_multiprocess.py (2-process CPU
    cluster running sharded fits whose psums span processes).
    """
    import time

    # authoritative idempotence check (jax>=0.4.34 exposes it); the
    # message sniff below is only a fallback for a concurrent-init race
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return

    def _is_reinit(e: Exception) -> bool:
        msg = str(e).lower()
        # jax 0.9: "distributed.initialize should only be called once.";
        # older: "...called more than once" / "already initialized"
        return (
            "only be called once" in msg
            or "more than once" in msg
            or "already initialized" in msg
        )

    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
            return
        except RuntimeError as e:
            if _is_reinit(e):
                return
            last = e
            if attempt < retries:
                time.sleep(retry_delay_sec)
    raise RuntimeError(
        f"jax.distributed.initialize failed after {retries + 1} attempts "
        f"(coordinator={coordinator_address})"
    ) from last
