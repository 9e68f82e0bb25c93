"""Multi-PROCESS distributed correctness (VERDICT r02 #5).

All other distributed tests run single-process over 8 virtual devices,
which never exercises the cross-process collective path (a real
cluster's cross-host psums).  Here we launch a 2-process jax.distributed CPU cluster
(coordinator + worker subprocesses) whose mesh spans both processes, run
the row-sharded GSPMD fit AND the explicit shard_map+psum fit, and each
process asserts the replicated result equals its independently computed
single-process fit.

Reference analogue: none (the reference is single-process by design —
SURVEY.md §2 parallelism table, multi-host row).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n", [2, 4])
def test_multi_process_fit_and_streaming_stats(tmp_path, n):
    """n-process cluster: process-spanning GSPMD + shard_map fits AND
    the streaming-statistics merge dataflow (per-process partials over
    disjoint row ranges, cluster-wide gather + merge) — the actual
    multi-host north-star path (VERDICT r04 #5)."""
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "multiprocess_worker.py")
    coord = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # workers set their own device counts

    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(n), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            cwd=os.path.dirname(here),
        )
        for i in range(n)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=540)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} rc={rc}\nstderr:\n{err[-3000:]}"
        assert f"WORKER_OK {i}" in out, f"worker {i} output: {out!r}"
