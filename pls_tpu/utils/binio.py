"""Binary (.npy) matrix ingest: disk → host → device, double-buffered.

The reference's pipeline starts at disk (`read_matrix_file`,
/root/reference/src/pls.cpp:37-67, driven at src/main.cpp:21-22) — but
CSV is the wrong container at the 1M×10k north-star scale (40 GB of X):
parsing dominates and the bytes are ~2.5× the binary size.  This module
is the production ingest path: standard .npy files (numpy's format, so
any tool can produce them), streamed in row chunks with

  1. a background reader thread issuing `os.pread` into preallocated
     buffers — pread is a raw syscall that RELEASES the GIL, so disk
     latency genuinely overlaps Python-side work (a numpy memmap copy
     would page-fault with the GIL held);
  2. a device-transfer lookahead (`device_stream`): the next chunk's
     `jax.device_put` is issued while the accumulator consumes the
     current one, hiding host→device latency behind compute.

Throughput is bounded by min(disk read, host→device transfer) — both
measured by benchmarks/ingest_bench.py; the device-side XᵀX/XᵀY
accumulation (models/streaming.py) is expected to be far faster than
either, so the pipeline should run at the IO bound, the physical optimum
for a single pass (not yet measured on a GPU host).  Store X as bfloat16
on disk (`x_storage="bf16"` end to end) to halve BOTH bounds; the
accumulator then multiplies in bf16 with f32 accumulation
(StatsAccumulator x_storage docs).

No native-code reader is needed here, unlike the CSV path (native/
pls_native.cpp): there is nothing to parse — pread into a buffer IS the
optimal loader, in any language.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

# Rotating-pool size for stream_npy(reuse_buffers=True).  The reader
# thread leads the newest yielded chunk by ≤3 (2 queued + 1 in
# progress), so a P-slot pool keeps a yielded chunk intact for P-4 more
# yields; device_stream holds a chunk across exactly 1 further yield
# (its in-flight transfer), so P=5 is the minimum and 6 adds margin.
_POOL_SLOTS = 6


def _npy_layout(path: str) -> tuple[tuple[int, ...], np.dtype, int, bool]:
    """(shape, dtype, data_offset_bytes, fortran_order) of a .npy file,
    using numpy's PUBLIC header parsers (no data read, no private APIs —
    `np.lib.format.read_array_header_{1,2}_0` are documented stable)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            raise ValueError(
                f"{path}: unsupported .npy format version {version} "
                "(streamable ingest supports 1.0 and 2.0)"
            )
        if dtype.kind == "V" and dtype.itemsize == 2 and dtype.names is None:
            # bfloat16 round-trips through the .npy descr as a 2-byte
            # void ('|V2') — the same convention jnp.save/load uses;
            # map it back so bf16-on-disk streams as bf16
            import ml_dtypes

            dtype = np.dtype(ml_dtypes.bfloat16)
        return shape, dtype, f.tell(), fortran


def npy_shape(path: str) -> tuple[tuple[int, ...], np.dtype]:
    """(shape, dtype) of a .npy file from its header alone."""
    shape, dtype, _, _ = _npy_layout(path)
    return shape, dtype


def write_npy_chunked(path: str, chunks, *, dtype=None) -> tuple[int, int]:
    """Write an iterable of (rows, K) blocks as ONE .npy file without ever
    materializing the full matrix (the generator side of the out-of-core
    story).  All chunks must share K and dtype (or be castable to
    `dtype`).  Returns the final (N, K).

    The header is written with a placeholder row count and patched in
    place at the end — the .npy format reserves padded header space, and
    we format the shape field to a fixed width so the patch never moves
    the data offset.
    """
    it = iter(chunks)
    try:
        first = np.ascontiguousarray(next(it))
    except StopIteration:
        # don't let a bare StopIteration escape (PEP 479 turns it into an
        # opaque RuntimeError inside generators)
        raise ValueError("write_npy_chunked: empty chunk iterable") from None
    if dtype is not None:
        first = first.astype(dtype, copy=False)
    K = first.shape[1] if first.ndim == 2 else 1
    first = first.reshape(first.shape[0], K)
    with open(path, "wb") as f:
        # write the placeholder header with a 16-digit sentinel row count
        # so the final patch can only be equal-or-shorter — the real N's
        # digits always fit inside the reserved (64-byte-aligned) header
        header = {
            "descr": np.lib.format.dtype_to_descr(first.dtype),
            "fortran_order": False,
            "shape": (10**15, K),
        }
        np.lib.format.write_array_header_1_0(f, header)
        data_off = f.tell()
        n = 0
        import itertools

        for chunk in itertools.chain([first], it):
            chunk = np.ascontiguousarray(chunk).astype(first.dtype, copy=False)
            chunk = chunk.reshape(chunk.shape[0], K)
            # tofile writes straight from the array buffer — no tobytes
            # copy (655 MB/chunk at north-star shapes); flush first so
            # the buffered header/data ordering is preserved
            f.flush()
            chunk.tofile(f)
            n += chunk.shape[0]
    if n > 10**15:
        raise ValueError("write_npy_chunked: more than 1e15 rows")
    # patch the true N into the header; if the shorter shape string lands
    # in a smaller 64-byte padding bucket, re-pad to the ORIGINAL data
    # offset and fix the v1 header-length field so np.load still finds
    # the data exactly at data_off
    import struct

    with open(path, "r+b") as f:
        header["shape"] = (n, K)
        np.lib.format.write_array_header_1_0(f, header)
        pos = f.tell()
        if pos > data_off:
            raise ValueError(
                "npy header grew while patching the row count — file corrupt"
            )
        if pos < data_off:
            hlen = data_off - 10  # v1.0: magic(6) + version(2) + len(2)
            if hlen > 0xFFFF:
                raise ValueError("npy v1 header length overflow")
            f.seek(8)
            f.write(struct.pack("<H", hlen))
            f.seek(pos - 1)
            f.write(b" " * (data_off - pos) + b"\n")
    return n, K


# O_DIRECT alignment: logical-block multiple for offset/length/buffer.
# 4096 covers every common config (512e/4Kn disks, ext4/xfs).
_DIRECT_ALIGN = 4096


def stream_npy(
    path: str, chunk_rows: int, *, threaded: bool = True,
    reuse_buffers: bool = False, direct: bool | None = None,
):
    """Yield (rows ≤ chunk_rows, K) C-contiguous blocks of a 2-D .npy
    (a 1-D file of shape (N,) streams as (N, 1) — the M=1 convention).

    threaded=True (default): a background thread pread()s chunk i+1 from
    disk while chunk i is being consumed — double-buffered, bounded at 2
    chunks in flight.  The thread spends its time in the pread syscall
    (GIL released), so the overlap is real.

    reuse_buffers=True: chunks are backed by a rotating pool of
    `_POOL_SLOTS` (6) preallocated buffers instead of fresh allocations —
    a fresh 655 MB allocation per chunk page-faults, which on a small
    host can cost more than the disk read itself.
    Validity contract: the reader thread runs at most 3 chunks ahead of
    the newest yielded chunk (2 parked in the queue + 1 being pread),
    and chunk c's buffer is reused for chunk c+6 — so a yielded chunk
    is guaranteed intact until TWO more chunks have been yielded, and
    may be overwritten any time after the third.  `device_stream` needs
    chunk c intact only until chunk c+1 has been yielded (it force-
    completes c's host→device transfer at that point — jax requires the
    host buffer immutable until the async device_put finishes), leaving
    one yield of safety margin; a 4-slot pool, by contrast, would let
    the reader clobber a chunk whose transfer is still in flight
    whenever disk outpaces the transfer link (the r04 advisor race).
    Use the default for consumers that retain chunks longer.

    direct=None (auto, default) uses O_DIRECT reads when
    reuse_buffers=True and the filesystem supports it — DMA straight
    into the (page-aligned mmap) pool slots, bypassing the page cache.
    On a small host the buffered path can be bound by the kernel's
    page-cache copy rather than the disk; O_DIRECT avoids that copy.
    Each chunk's byte span is widened to 4096-byte-aligned bounds (the
    yielded array is a zero-copy view at the true offset) and the
    file's final partial block falls back to one small buffered read.
    direct=True forces it (raises if the open fails); False disables.
    """
    shape, dtype, off, fortran = _npy_layout(path)
    if len(shape) == 1:
        # 1-D response vectors are the library-wide convention for M=1
        # (utils/io.py, model.py promote them); stream as (N, 1)
        shape = (shape[0], 1)
    if len(shape) != 2:
        raise ValueError(f"{path}: expected 1-D or 2-D array, got shape {shape}")
    if fortran:
        raise ValueError(f"{path}: fortran-order arrays are not streamable")
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    if direct and not reuse_buffers:
        raise ValueError(
            "direct=True requires reuse_buffers=True (O_DIRECT DMAs into "
            "the page-aligned buffer pool; the unpooled path has no "
            "aligned targets)"
        )
    N, K = shape
    row_bytes = K * dtype.itemsize
    fsize = os.path.getsize(path)

    fd_direct = -1
    if reuse_buffers and direct is not False:
        try:
            fd_direct = os.open(path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            if direct:
                raise
            fd_direct = -1

    pool: list | None = None
    if reuse_buffers:
        import mmap as _mmap

        # page-aligned slots (mmap) so O_DIRECT DMA targets are valid;
        # +2 blocks of slack for the span widening on both ends
        slot_bytes = chunk_rows * row_bytes + 2 * _DIRECT_ALIGN
        pool = [_mmap.mmap(-1, slot_bytes) for _ in range(_POOL_SLOTS)]

    def read_chunk(fd: int, idx: int, start: int) -> np.ndarray:
        rows = min(chunk_rows, N - start)
        nbytes = rows * row_bytes
        pos = off + start * row_bytes
        if pool is not None:
            slot = pool[idx % _POOL_SLOTS]
            if fd_direct >= 0:
                # widen to aligned bounds; DMA the aligned span, then
                # buffered-read any unaligned tail at EOF
                astart = pos - (pos % _DIRECT_ALIGN)
                want_end = pos + nbytes
                aend = min(
                    -(-want_end // _DIRECT_ALIGN) * _DIRECT_ALIGN,
                    fsize - (fsize % _DIRECT_ALIGN),
                )
                aend = max(aend, astart)
                mv = memoryview(slot)
                if aend > astart:
                    _pread_into(fd_direct, mv[: aend - astart], astart)
                if aend < want_end:  # file tail past the last full block
                    _pread_into(
                        fd, mv[aend - astart : want_end - astart], aend
                    )
                return np.frombuffer(
                    mv, dtype=dtype, count=rows * K, offset=pos - astart
                ).reshape(rows, K)
            mv = memoryview(slot)[:nbytes]
            _pread_into(fd, mv, pos)
            return np.frombuffer(mv, dtype=dtype).reshape(rows, K)
        return np.frombuffer(
            _pread_exact(fd, nbytes, pos), dtype=dtype
        ).reshape(rows, K)

    if not threaded:
        fd = os.open(path, os.O_RDONLY)
        try:
            for idx, start in enumerate(range(0, N, chunk_rows)):
                yield read_chunk(fd, idx, start)
        finally:
            os.close(fd)
            if fd_direct >= 0:
                os.close(fd_direct)
        return

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def reader():
        fd = os.open(path, os.O_RDONLY)
        try:
            for idx, start in enumerate(range(0, N, chunk_rows)):
                if stop.is_set():
                    return
                q.put(read_chunk(fd, idx, start))
            q.put(None)
        except BaseException as e:  # surface IO errors on the consumer side
            q.put(e)
        finally:
            os.close(fd)
            if fd_direct >= 0:
                os.close(fd_direct)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so the producer's blocked put() wakes and sees stop
        while not q.empty():
            q.get_nowait()


def _pread_exact(fd: int, nbytes: int, offset: int) -> bytes:
    parts = []
    while nbytes:
        b = os.pread(fd, nbytes, offset)
        if not b:
            raise IOError("unexpected EOF")
        parts.append(b)
        nbytes -= len(b)
        offset += len(b)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def _pread_into(fd: int, mv: memoryview, offset: int) -> None:
    """pread directly into an existing buffer (no allocation; the
    syscall releases the GIL)."""
    pos = 0
    total = len(mv)
    while pos < total:
        got = os.preadv(fd, [mv[pos:]], offset + pos)
        if got <= 0:
            raise IOError("unexpected EOF")
        pos += got


def device_stream(chunks, *, cast=None):
    """Iterate device arrays with ONE transfer in flight ahead of the
    consumer: `jax.device_put(chunk[i+1])` is issued (asynchronous on
    accelerator backends) before chunk i is yielded, so the host→device copy of the
    next chunk overlaps the device compute on the current one.

    Each array is block_until_ready'd just before it is yielded: its
    transfer is complete by then anyway (the next transfer is already
    queued behind it, preserving the overlap), and the explicit barrier
    guarantees the HOST buffer backing it is free — which makes this
    safe to compose with stream_npy(reuse_buffers=True)'s rotating
    buffer pool.

    cast: optional dtype applied ON HOST before the transfer — pass
    jnp.bfloat16 to halve the transfer bytes (the x_storage="bf16"
    ingest path; numpy handles the cast via ml_dtypes).
    """
    import jax

    # On the CPU backend device_put can ZERO-COPY (the "device" array
    # aliases the host buffer) — incompatible with rotating reused
    # buffers upstream; force a real copy there.  Accelerator backends
    # genuinely transfer, so no copy is added on the production path.
    force_copy = jax.default_backend() == "cpu"

    it = iter(chunks)
    prev = None
    cast_pool: list = [None, None, None]  # rotating cast buffers (alloc tax)
    for i, chunk in enumerate(it):
        if cast is not None and chunk.dtype != cast:
            slot = i % 3
            buf = cast_pool[slot]
            if buf is None or buf.shape != chunk.shape:
                buf = np.empty(chunk.shape, np.dtype(cast))
                cast_pool[slot] = buf
            np.copyto(buf, chunk, casting="unsafe")
            chunk = buf
        if force_copy:
            chunk = np.array(chunk)
        cur = jax.device_put(chunk)
        if prev is not None:
            yield jax.block_until_ready(prev)
        prev = cur
    if prev is not None:
        yield jax.block_until_ready(prev)


def npy_chunks(
    x_path: str, y_path: str, chunk_rows: int, *, threaded=True,
    reuse_buffers: bool = False,
):
    """Aligned (X_chunk, Y_chunk) blocks of two .npy files (the binary
    analogue of models/streaming.csv_chunks).  Raises on row-count
    mismatch.  reuse_buffers: see stream_npy — only for consumers that
    copy/consume each X chunk before the buffer pool wraps (see
    stream_npy's validity contract)."""
    (nx, _), _dt = npy_shape(x_path)
    shape_y, _ = npy_shape(y_path)
    if shape_y[0] != nx:
        raise ValueError(
            f"{x_path} and {y_path} have different numbers of rows"
        )
    xs = stream_npy(
        x_path, chunk_rows, threaded=threaded, reuse_buffers=reuse_buffers
    )
    ys = stream_npy(y_path, chunk_rows, threaded=False)  # tiny: no thread
    for xc, yc in zip(xs, ys):
        yield xc, yc


def auto_chunk_rows(x_dtype) -> int:
    """Default chunk size for the streaming accumulator: 32768 rows for
    narrow (bf16) storage and 16384 for f32 (the same bytes per chunk).
    Not yet tuned on the GPU (tools/accumulator_sweep.py sweeps it)."""
    return 32768 if np.dtype(x_dtype).itemsize < 4 else 16384


def fit_streaming_npy(
    x_path: str,
    y_path: str,
    A: int,
    *,
    chunk_rows: int | None = None,
    x_storage: str | None = None,
    dtype=None,
    **kw,
):
    """Out-of-core fit straight from .npy files — the binary analogue of
    models/streaming.fit_streaming_csv, with the threaded pread loader
    and the device-transfer lookahead.  X never exists in host or device
    memory beyond two chunks.

    x_storage="bf16": chunks are cast to bfloat16 on host (halving the
    host→device bytes) and accumulated in f32.  If the .npy
    itself is stored bfloat16, the disk read is halved too and no cast
    happens.  Pre-scaled data is assumed (the caller z-scores, as in the
    reference CLI); for exact streaming z-scoring use collect_moments +
    fit_streaming over `npy_chunks`.
    """
    acc = stats_from_npy(
        x_path, y_path, chunk_rows=chunk_rows, x_storage=x_storage,
        dtype=dtype,
    )
    return acc.fit(A, **kw)


def stats_from_npy(
    x_path: str,
    y_path: str,
    *,
    chunk_rows: int | None = None,
    x_storage: str | None = None,
    dtype=None,
    compensated: bool = False,
    stats_precision: str | None = None,
    sync_every: int = 1,
):
    """One streaming pass over binary files → StatsAccumulator holding
    XᵀX / XᵀY (the basis for fit_from_stats, cv_loo_from_stats, and
    cv_kfold_from_stats at north-star scale).

    chunk_rows=None picks the measured-optimum default for the on-disk
    dtype (auto_chunk_rows: 32768 narrow / 16384 f32).  Only an exactly
    bfloat16-on-disk file auto-selects the narrow matmul path; any other
    sub-4-byte dtype (float16, int16, int8, ...) is upcast to f32 on
    host so no mantissa bits or integer exactness are silently dropped
    (pass x_storage="bf16" to opt in to narrowing those).

    stats_precision: matmul precision of the accumulation itself
    ("highest" = exact-f32 chunk partials; None = backend default, TF32
    on an NVIDIA GPU — note a
    downstream fit's `precision="highest"` governs only the component
    loop, not this data pass).  compensated=True pins HIGHEST
    internally.

    sync_every: block on the accumulator every N chunks.  This is the
    pipeline's backpressure: async dispatch otherwise races arbitrarily
    far ahead of execution, and every outstanding chunk holds host
    memory.  The NEXT chunk's disk read still overlaps in the reader
    thread, so sync_every=1 costs only the transfer/compute overlap
    between adjacent chunks.  Whether that overlap is worth more on a
    GPU host is not measured yet.  0 disables.
    """
    import jax
    import jax.numpy as jnp

    from pls_tpu.models.streaming import StatsAccumulator

    (N, K), M, chunk_rows, cast, x_storage = _resolve_ingest(
        x_path, y_path, chunk_rows, x_storage, compensated
    )
    if dtype is None:
        dtype = jnp.float32
    acc = StatsAccumulator(
        K, M, dtype, compensated=compensated, x_storage=x_storage,
        precision=stats_precision,
    )
    xs = device_stream(
        stream_npy(x_path, chunk_rows, threaded=True, reuse_buffers=True),
        cast=cast,
    )
    ys = device_stream(stream_npy(y_path, chunk_rows, threaded=False), cast=cast)
    for i, (Xc, Yc) in enumerate(zip(xs, ys)):
        acc.update(Xc, Yc)
        if sync_every and (i + 1) % sync_every == 0:
            jax.block_until_ready(acc.XX)
    return acc


def _resolve_ingest(x_path: str, y_path: str, chunk_rows, x_storage,
                    compensated: bool = False):
    """Shared ingest-policy resolution (dtype gating + auto chunk size +
    X/Y row-count validation — zip() over two streams would otherwise
    silently truncate at the shorter file);
    returns ((N, K), M, chunk_rows, cast, x_storage).

    Auto-narrow gate: only an exactly-bfloat16-on-disk X selects the
    narrow matmul path by itself; any other sub-4-byte dtype (float16,
    int16, int8, ...) is upcast to f32 on host so no mantissa bits or
    integer exactness are silently dropped (pass x_storage="bf16" to
    opt in to narrowing those).
    """
    import jax.numpy as jnp
    import ml_dtypes

    shape_x, x_dtype = npy_shape(x_path)
    if len(shape_x) != 2:
        raise ValueError(f"{x_path}: X must be 2-D, got shape {shape_x}")
    N, K = shape_x
    shape_y, _ = npy_shape(y_path)
    M = shape_y[1] if len(shape_y) == 2 else 1
    if shape_y[0] != N:
        raise ValueError(
            f"row-count mismatch: {x_path} has {N} rows but {y_path} "
            f"has {shape_y[0]}"
        )
    if chunk_rows is None:
        chunk_rows = auto_chunk_rows(x_dtype)
    cast = jnp.bfloat16 if x_storage else None
    if x_dtype == np.dtype(ml_dtypes.bfloat16):
        cast = None
        if x_storage is None and not compensated:
            x_storage = "bf16"
    elif x_dtype.itemsize < 4 and cast is None:
        cast = jnp.float32
    return (N, K), M, chunk_rows, cast, x_storage


def fold_stats_from_npy(
    x_path: str,
    y_path: str,
    assignments: np.ndarray,
    k: int,
    *,
    chunk_rows: int | None = None,
    x_storage: str | None = None,
    dtype=None,
    stats_precision: str | None = None,
    sync_every: int = 1,
):
    """ONE streaming pass over binary files → per-fold sufficient
    statistics (models/streaming.FoldStatsAccumulator) — the data pass
    of the one-pass k-fold CV.  Identical ingest policy to
    stats_from_npy (threaded pread pool, device lookahead, bf16-on-disk
    auto-narrow, auto chunk size); the global XX/XY come for free as
    the fold sums.  `assignments` is the (N,) fold label of every row
    (cv/kfold.kfold_assignments)."""
    import jax

    from pls_tpu.models.streaming import FoldStatsAccumulator

    import jax.numpy as jnp

    (N, K), M, chunk_rows, cast, x_storage = _resolve_ingest(
        x_path, y_path, chunk_rows, x_storage
    )
    from pls_tpu.cv.kfold import _check_assignments

    assignments = np.asarray(_check_assignments(assignments, k), np.int32)
    if assignments.shape != (N,):
        raise ValueError(
            f"assignments shape {assignments.shape} != ({N},)"
        )
    if dtype is None:
        dtype = jnp.float32
    acc = FoldStatsAccumulator(
        K, M, k, dtype, x_storage=x_storage, precision=stats_precision
    )
    xs = device_stream(
        stream_npy(x_path, chunk_rows, threaded=True, reuse_buffers=True),
        cast=cast,
    )
    ys = device_stream(stream_npy(y_path, chunk_rows, threaded=False), cast=cast)
    start = 0
    for i, (Xc, Yc) in enumerate(zip(xs, ys)):
        rows = Xc.shape[0]
        acc.update(Xc, Yc, assignments[start : start + rows])
        start += rows
        if sync_every and (i + 1) % sync_every == 0:
            jax.block_until_ready(acc.XXf)
    return acc


def cv_kfold_npy(
    x_path: str,
    y_path: str,
    A: int,
    k: int = 10,
    *,
    key=0,
    assignments: np.ndarray | None = None,
    chunk_rows: int | None = None,
    x_storage: str | None = None,
    residual_pass: bool = True,
    zscore: bool = False,
    power_iters: int | None = None,
    precision: str | None = "highest",
    stats_precision: str | None = None,
    sync_every: int = 1,
):
    """K-fold cross-validation straight from .npy files in TWO total
    passes over X — the scalable replacement for re-streaming each
    fold's block (1 + k passes, cv_kfold_from_stats):

      pass 1: per-fold XXf/XYf/YYf accumulated while the data streams
              (fold_stats_from_npy); PRESS/MSE/RMSE then close in
              statistics space with no further IO (cv_kfold_onepass);
      pass 2 (residual_pass=True): ONE combined sweep applying each
              row's own fold model at every truncation
              (cv/kfold.fold_residual_chunk) → per-row errors for the
              Wilcoxon optimal-component selector.

    Returns (KFoldOnePass, Residual | None): the closed-form summary
    and, when residual_pass, the (M, N, A) Residual (errors held as
    host numpy — N-sized) feeding cv/validation unchanged.

    zscore=True: the files hold RAW data; the fold statistics of the
    globally column-standardized data are derived in closed form from
    the raw statistics + column sums gathered in the same pass
    (models/streaming.zscore_fold_stats — the reference CLI's
    z-score-then-CV pipeline with zero extra passes), and residual-pass
    chunks are standardized on device.  See zscore_stats for the
    cancellation caveat with extreme column offsets.

    Precision knobs: `precision` governs the X-free closed form (the
    per-fold component loops and PRESS contractions); `stats_precision`
    governs the data pass itself — the XXf/XYf Gram accumulation, whose
    default-precision rounding (~1e-3 relative for TF32 on an NVIDIA
    GPU) is the
    dominant error term in the cancelling PRESS combination.  bf16-on-
    disk files are unaffected (bf16 products are exact in f32).

    Reference analogue: /root/reference/src/pls.cpp:512-549 (fold
    refits) + 265-289 (the selector's need for per-row errors).  LSO
    note: Monte-Carlo trials are not a partition, so the one-pass trick
    does not apply; for disk-scale LSO run this with R different `key`s
    (repeated k-fold, 2R passes) or use cv_lso_rowsharded in-memory.
    """
    import jax.numpy as jnp

    from pls_tpu.cv.kfold import (
        cv_kfold_onepass,
        fold_residual_chunk,
        kfold_assignments,
    )
    from pls_tpu.types import Residual

    (N, K), _ = npy_shape(x_path)
    if assignments is None:
        assignments = np.asarray(kfold_assignments(N, k, key))
    assignments = np.asarray(assignments, np.int32)

    facc = fold_stats_from_npy(
        x_path, y_path, assignments, k,
        chunk_rows=chunk_rows, x_storage=x_storage,
        stats_precision=stats_precision, sync_every=sync_every,
    )
    scale = None
    if zscore:
        facc = facc.zscored()
        scale = (facc.mx, facc.sdx, facc.my, facc.sdy)
    summary = cv_kfold_onepass(
        facc, A, power_iters=power_iters, precision=precision
    )
    if not residual_pass:
        return summary, None

    (N_, K_), M_, chunk_rows_, cast, _ = _resolve_ingest(
        x_path, y_path, chunk_rows, x_storage
    )
    import jax

    B = summary.B  # (k, A, K, M)
    errs = np.empty((N, A, B.shape[3]), np.float32)
    xs = device_stream(
        stream_npy(x_path, chunk_rows_, threaded=True, reuse_buffers=True),
        cast=cast,
    )
    ys = device_stream(stream_npy(y_path, chunk_rows_, threaded=False))
    start = 0
    for Xc, Yc in zip(xs, ys):
        rows = Xc.shape[0]
        if Yc.ndim == 1:
            Yc = Yc[:, None]
        if scale is not None:
            mx, sdx, my, sdy = scale
            Xc = (Xc.astype(mx.dtype) - mx[None, :]) / sdx[None, :]
            Yc = (Yc.astype(my.dtype) - my[None, :]) / sdy[None, :]
        e = fold_residual_chunk(
            B, Xc, Yc, jnp.asarray(assignments[start : start + rows])
        )
        # device→host immediately: errors are the only N-sized object
        errs[start : start + rows] = np.asarray(e)
        start += rows
    # errors stay host-resident numpy (N-sized — 800 MB at the north
    # star); jnp ops convert lazily at use, and host-side summaries
    # (PRESS sums, Wilcoxon ranks on CPU backend) need no transfer
    res = Residual(
        errors=np.ascontiguousarray(np.transpose(errs, (2, 0, 1))),
        method=f"{k}-FOLD",
    )
    return summary, res


def cv_repeated_kfold_npy(
    x_path: str,
    y_path: str,
    A: int,
    k: int = 10,
    repeats: int = 5,
    *,
    key=0,
    residual_pass: bool = False,
    **kw,
):
    """Repeated k-fold from disk — the disk-scale Monte-Carlo CV.

    The reference's LSO draws `trials` independent shuffle-splits
    (/root/reference/src/pls.cpp:512-549), which cannot ride the
    one-pass fold-statistics trick (trials are not a partition).  The
    scalable equivalent is R independent balanced k-fold partitions:
    each repeat is one (or two, with residual_pass) disk passes via
    cv_kfold_npy, so the whole sweep costs R·(1..2) passes instead of
    trials+1 — and every row is held out exactly R times, giving the
    same variance-reduction role as LSO replicates.

    Returns (press_mean, rmse_mean, runs): the (M, A) float64 PRESS and
    RMSE averaged over repeats, plus the per-repeat
    [(KFoldOnePass, Residual|None), ...] for dispersion estimates.
    """
    import jax

    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    base = jax.random.key(key) if isinstance(key, int) else key
    runs = []
    press_sum = None
    for r in range(repeats):
        sub = jax.random.fold_in(base, r)
        s, res = cv_kfold_npy(
            x_path, y_path, A, k=k, key=sub,
            residual_pass=residual_pass, **kw,
        )
        runs.append((s, res))
        press_sum = s.press if press_sum is None else press_sum + s.press
    press_mean = press_sum / repeats
    n = runs[0][0].nf.sum()
    rmse_mean = np.sqrt(press_mean / float(n))
    return press_mean, rmse_mean, runs
