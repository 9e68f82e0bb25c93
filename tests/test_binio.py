"""Binary (.npy) ingest path: chunked writer, threaded pread streamer,
device-transfer lookahead, and the end-to-end streaming fit — the
production analogue of the reference's CSV loader
(/root/reference/src/pls.cpp:37-67) at scales where CSV is untenable."""

import numpy as np
import pytest

import jax.numpy as jnp

import pls_tpu as pt
from pls_tpu.utils.binio import (
    device_stream,
    fit_streaming_npy,
    npy_chunks,
    npy_shape,
    stats_from_npy,
    stream_npy,
    write_npy_chunked,
)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("binio")
    rng = np.random.default_rng(5)
    X = rng.normal(size=(500, 24)).astype(np.float32)
    Y = (X @ rng.normal(size=(24, 2)) + 0.1 * rng.normal(size=(500, 2))).astype(
        np.float32
    )
    xp, yp = str(d / "x.npy"), str(d / "y.npy")
    write_npy_chunked(xp, (X[i : i + 128] for i in range(0, 500, 128)))
    write_npy_chunked(yp, [Y])
    return xp, yp, X, Y


class TestNpyRoundtrip:
    def test_chunked_writer_is_plain_npy(self, files):
        xp, _, X, _ = files
        np.testing.assert_array_equal(np.load(xp), X)

    def test_header_shape(self, files):
        xp, _, X, _ = files
        shape, dtype = npy_shape(xp)
        assert shape == X.shape and dtype == np.float32

    @pytest.mark.parametrize("threaded", [True, False])
    def test_stream_chunks(self, files, threaded):
        xp, _, X, _ = files
        chunks = list(stream_npy(xp, 200, threaded=threaded))
        assert [c.shape[0] for c in chunks] == [200, 200, 100]
        np.testing.assert_array_equal(np.concatenate(chunks), X)

    def test_bf16_roundtrip(self, tmp_path):
        import ml_dtypes

        X = np.linspace(-3, 3, 64, dtype=np.float32).reshape(8, 8)
        Xb = X.astype(ml_dtypes.bfloat16)
        p = str(tmp_path / "b.npy")
        write_npy_chunked(p, [Xb])
        shape, dtype = npy_shape(p)
        assert shape == (8, 8) and dtype == np.dtype(ml_dtypes.bfloat16)
        got = np.concatenate(list(stream_npy(p, 3)))
        np.testing.assert_array_equal(
            got.astype(np.float32), Xb.astype(np.float32)
        )

    def test_early_consumer_exit_does_not_hang(self, files):
        xp, _, _, _ = files
        it = stream_npy(xp, 100, threaded=True)
        next(it)
        it.close()  # generator close must stop the reader thread

    def test_row_mismatch_raises(self, files, tmp_path):
        xp, _, _, _ = files
        bad = str(tmp_path / "bad.npy")
        write_npy_chunked(bad, [np.zeros((3, 2), np.float32)])
        with pytest.raises(ValueError, match="different numbers of rows"):
            list(npy_chunks(xp, bad, 100))


class TestDeviceStream:
    def test_lookahead_preserves_order_and_values(self, files):
        xp, _, X, _ = files
        outs = list(device_stream(stream_npy(xp, 150)))
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(o) for o in outs]), X
        )

    def test_cast_narrows(self, files):
        xp, _, _, _ = files
        outs = list(device_stream(stream_npy(xp, 300), cast=jnp.bfloat16))
        assert all(o.dtype == jnp.bfloat16 for o in outs)


class TestStreamingFitParity:
    def test_fit_matches_in_memory_stats(self, files):
        from pls_tpu.models.kernel_pls import fit_from_stats

        xp, yp, X, Y = files
        f1 = fit_streaming_npy(xp, yp, 4, chunk_rows=128)
        f2 = fit_from_stats(jnp.asarray(X.T @ X), jnp.asarray(X.T @ Y), 4)
        np.testing.assert_allclose(
            np.asarray(pt.coefficients(f1)),
            np.asarray(pt.coefficients(f2)),
            atol=1e-5,
        )

    def test_stats_accumulator_counts(self, files):
        xp, yp, X, _ = files
        acc = stats_from_npy(xp, yp, chunk_rows=64)
        assert int(acc.n) == X.shape[0]

    def test_bf16_on_disk_autonarrows(self, tmp_path, files):
        import ml_dtypes

        xp, yp, X, Y = files
        xb = str(tmp_path / "xb.npy")
        write_npy_chunked(xb, [X.astype(ml_dtypes.bfloat16)])
        acc = stats_from_npy(xb, yp, chunk_rows=128)
        ref = stats_from_npy(xp, yp, chunk_rows=128, x_storage="bf16")
        np.testing.assert_array_equal(
            np.asarray(acc.XX), np.asarray(ref.XX)
        )

    def test_float16_on_disk_upcasts_not_narrows(self, tmp_path, files):
        """ADVICE r04: a float16 .npy must NOT silently ride the bf16
        path (that would drop f16 mantissa bits 10->7); it upcasts to
        f32 on host instead."""
        xp, yp, X, Y = files
        xh = str(tmp_path / "xh.npy")
        Xh = X.astype(np.float16)
        write_npy_chunked(xh, [Xh])
        acc = stats_from_npy(xh, yp, chunk_rows=128)
        assert acc.x_storage is None  # narrow matmul path not taken
        Xf = Xh.astype(np.float32)
        ref = Xf.T @ Xf
        # f32 accumulation-order differences only; bf16 rounding of the
        # f16 values would show up at ~4e-3 relative
        np.testing.assert_allclose(np.asarray(acc.XX), ref, rtol=1e-4,
                                   atol=1e-3 * np.abs(ref).max())

    def test_auto_chunk_rows_defaults(self):
        from pls_tpu.utils.binio import auto_chunk_rows
        import ml_dtypes

        assert auto_chunk_rows(np.float32) == 16384
        assert auto_chunk_rows(ml_dtypes.bfloat16) == 32768
        assert auto_chunk_rows(np.float16) == 32768

    def test_chunk_rows_none_resolves(self, files):
        xp, yp, X, _ = files
        acc = stats_from_npy(xp, yp)  # auto chunk size
        np.testing.assert_allclose(
            np.asarray(acc.XX), X.T @ X, rtol=1e-5
        )

    def test_feeds_cv_from_stats(self, files):
        """The north-star CV wiring: stats from disk + block-downdate
        k-fold over re-streamed fold blocks."""
        from pls_tpu.cv.kfold import cv_kfold_from_stats

        xp, yp, X, Y = files
        acc = stats_from_npy(xp, yp, chunk_rows=128)
        N = X.shape[0]
        k = 5
        assign = np.arange(N) * k // N
        folds = ((X[assign == f], Y[assign == f]) for f in range(k))
        got = cv_kfold_from_stats(acc.XX, acc.XY, folds, 3)
        ref = pt.cv_kfold_downdate(
            jnp.asarray(X), jnp.asarray(Y), 3, k=k, assignments=assign
        )
        np.testing.assert_allclose(
            np.asarray(got.errors), np.asarray(ref.errors), atol=2e-4
        )


class TestOnePassKFoldNpy:
    """cv_kfold_npy: k-fold CV from disk in 2 total passes (VERDICT r04
    #1), vs the 1+k-pass re-streaming path it replaces."""

    def test_two_pass_cv_matches_restreaming_path(self, files):
        from pls_tpu.cv.kfold import cv_kfold_from_stats, kfold_assignments
        from pls_tpu.cv.validation import optimal_num_components, validation
        from pls_tpu.utils.binio import cv_kfold_npy

        xp, yp, X, Y = files
        N = X.shape[0]
        k, A = 5, 4
        assign = np.asarray(kfold_assignments(N, k, key=9))
        summary, res = cv_kfold_npy(
            xp, yp, A, k=k, assignments=assign, chunk_rows=128)
        # closed-form PRESS vs the residual-based re-streaming path
        acc = stats_from_npy(xp, yp, chunk_rows=128)
        order = np.concatenate([np.flatnonzero(assign == f) for f in range(k)])
        folds = ((X[assign == f], Y[assign == f]) for f in range(k))
        ref = cv_kfold_from_stats(acc.XX, acc.XY, folds, A)
        press_ref = np.asarray(validation(ref)).astype(np.float64)
        # this fixture is NOT z-scored: PRESS ~ 21 against Y energy
        # ~ 8400, so f32 statistics noise amplifies ~400x through the
        # cancellation — tolerance scales with the Y energy.  The strict
        # 1e-5 relative pin on z-scored data (the pipeline regime) is
        # tests/test_kfold.py::test_closed_form_press_matches_residual_based.
        yy_energy = float(np.sum(Y.astype(np.float64) ** 2, axis=0).max())
        np.testing.assert_allclose(
            summary.press, press_ref, rtol=2e-4, atol=1e-5 * yy_energy)
        # per-row errors agree too (re-order the concatenated reference)
        errs_ref = np.asarray(ref.errors)[:, np.argsort(order), :]
        np.testing.assert_allclose(
            np.asarray(res.errors), errs_ref, rtol=1e-4, atol=1e-4)
        # and the optimal-component picks coincide
        np.testing.assert_array_equal(
            np.asarray(optimal_num_components(res)),
            np.asarray(optimal_num_components(ref)))

    def test_press_only_skips_second_pass(self, files):
        from pls_tpu.utils.binio import cv_kfold_npy

        xp, yp, X, _ = files
        summary, res = cv_kfold_npy(
            xp, yp, 3, k=4, key=1, chunk_rows=200, residual_pass=False)
        assert res is None
        assert summary.press.shape == (2, 3)
        assert summary.n_obs == X.shape[0]

    def test_zscore_from_raw_files(self, tmp_path):
        """cv_kfold_npy(zscore=True) on RAW files must match running
        the plain path on explicitly pre-z-scored files — one pass
        instead of moments + scaled passes."""
        from pls_tpu.cv.kfold import kfold_assignments
        from pls_tpu.utils.binio import cv_kfold_npy

        rng = np.random.default_rng(31)
        X = (rng.normal(size=(400, 20)) * 2 + 7).astype(np.float32)
        Y = (X @ rng.normal(size=(20, 2)) + rng.normal(size=(400, 2))
             ).astype(np.float32)
        Xz = (X - X.mean(0)) / X.std(0, ddof=1)
        Yz = (Y - Y.mean(0)) / Y.std(0, ddof=1)
        raw_x, raw_y = str(tmp_path / "rx.npy"), str(tmp_path / "ry.npy")
        z_x, z_y = str(tmp_path / "zx.npy"), str(tmp_path / "zy.npy")
        write_npy_chunked(raw_x, [X]); write_npy_chunked(raw_y, [Y])
        write_npy_chunked(z_x, [Xz.astype(np.float32)])
        write_npy_chunked(z_y, [Yz.astype(np.float32)])
        assign = np.asarray(kfold_assignments(400, 4, key=2))
        s_raw, r_raw = cv_kfold_npy(
            raw_x, raw_y, 3, k=4, assignments=assign, chunk_rows=128,
            zscore=True)
        s_pre, r_pre = cv_kfold_npy(
            z_x, z_y, 3, k=4, assignments=assign, chunk_rows=128)
        np.testing.assert_allclose(s_raw.press, s_pre.press, rtol=1e-3)
        np.testing.assert_allclose(
            np.asarray(r_raw.errors), np.asarray(r_pre.errors),
            rtol=1e-2, atol=1e-3)

    def test_repeated_kfold(self, files):
        from pls_tpu.utils.binio import cv_kfold_npy, cv_repeated_kfold_npy

        xp, yp, X, _ = files
        press, rmse, runs = cv_repeated_kfold_npy(
            xp, yp, 3, k=4, repeats=2, key=5, chunk_rows=200)
        assert press.shape == (2, 3) and rmse.shape == (2, 3)
        assert len(runs) == 2 and runs[0][1] is None
        # the average is the mean of the per-repeat PRESS matrices
        manual = (runs[0][0].press + runs[1][0].press) / 2
        np.testing.assert_allclose(press, manual)
        # distinct partitions per repeat (folds differ -> press differs)
        assert not np.allclose(runs[0][0].press, runs[1][0].press)

    def test_bf16_on_disk(self, tmp_path, files):
        import ml_dtypes

        from pls_tpu.utils.binio import cv_kfold_npy

        xp, yp, X, Y = files
        xb = str(tmp_path / "xb.npy")
        write_npy_chunked(xb, [X.astype(ml_dtypes.bfloat16)])
        s_b, _ = cv_kfold_npy(xb, yp, 3, k=4, key=2, chunk_rows=200,
                              residual_pass=False)
        s_f, _ = cv_kfold_npy(xp, yp, 3, k=4, key=2, chunk_rows=200,
                              residual_pass=False)
        np.testing.assert_allclose(s_b.press, s_f.press, rtol=5e-2)


class TestReusedBuffers:
    def test_reuse_buffers_values_correct_when_consumed_inline(self, files):
        xp, _, X, _ = files
        total = []
        for c in stream_npy(xp, 150, reuse_buffers=True):
            total.append(c.copy())  # consume before the pool wraps
        np.testing.assert_array_equal(np.concatenate(total), X)

    def test_device_stream_over_reused_buffers(self, files):
        """The composition the production ingest uses: rotating host
        buffers + blocked transfers must deliver exact values."""
        xp, _, X, _ = files
        outs = [
            np.asarray(o)
            for o in device_stream(
                stream_npy(xp, 100, reuse_buffers=True, threaded=True)
            )
        ]
        np.testing.assert_array_equal(np.concatenate(outs), X)

    def test_pool_contract_two_further_yields(self, files):
        """The r04-advisor race contract: with the 6-slot pool and the
        reader's ≤3-chunk lead, a yielded chunk must stay intact until
        TWO more chunks have been yielded (device_stream itself only
        needs one — the in-flight transfer)."""
        xp, _, X, _ = files
        held: list[np.ndarray] = []
        snaps: list[np.ndarray] = []
        for c in stream_npy(xp, 50, reuse_buffers=True, threaded=True):
            held.append(c)
            snaps.append(c.copy())
            if len(held) > 2:
                # the chunk yielded 2 iterations ago must be unclobbered
                np.testing.assert_array_equal(held[-3], snaps[-3])
                held.pop(0)
                snaps.pop(0)

    def test_direct_io_odd_sizes_match_buffered(self, tmp_path):
        """O_DIRECT path: unaligned data offset (npy header), chunk
        spans that straddle 4096-byte blocks, and a file whose byte
        length is NOT a block multiple (EOF tail via the buffered
        fallback) must all yield exact values."""
        rng = np.random.default_rng(7)
        X = rng.normal(size=(101, 37)).astype(np.float32)  # 148-B rows
        p = str(tmp_path / "odd.npy")
        write_npy_chunked(p, [X])
        import os

        assert os.path.getsize(p) % 4096 != 0  # the case under test
        for chunk in (7, 33, 101):
            got = np.concatenate([
                c.copy() for c in stream_npy(
                    p, chunk, reuse_buffers=True, direct=True)
            ])
            np.testing.assert_array_equal(got, X)
        # explicit opt-out still works
        got = np.concatenate([
            c.copy() for c in stream_npy(
                p, 33, reuse_buffers=True, direct=False)
        ])
        np.testing.assert_array_equal(got, X)

    def test_cast_pool_values(self, files):
        xp, _, X, _ = files
        outs = [
            np.asarray(o).astype(np.float32)
            for o in device_stream(
                stream_npy(xp, 100, reuse_buffers=True), cast=jnp.bfloat16
            )
        ]
        ref = X.astype(jnp.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(np.concatenate(outs), np.asarray(ref))


class TestIngestValidation:
    """r05 review findings: silent-truncation and misuse guards."""

    def test_row_count_mismatch_raises(self, files, tmp_path):
        """zip() over two independent streams must not silently truncate:
        X/Y row counts are validated up front (stats, fold-stats, and
        the kfold residual pass all share _resolve_ingest)."""
        xp, _, X, Y = files
        yshort = str(tmp_path / "yshort.npy")
        write_npy_chunked(yshort, [Y[:400]])
        with pytest.raises(ValueError, match="row-count mismatch"):
            stats_from_npy(xp, yshort)
        from pls_tpu.utils.binio import cv_kfold_npy, fold_stats_from_npy

        with pytest.raises(ValueError, match="row-count mismatch"):
            fold_stats_from_npy(xp, yshort, np.zeros(500, np.int32), 2)
        with pytest.raises(ValueError, match="row-count mismatch"):
            cv_kfold_npy(xp, yshort, 3, k=2)

    def test_1d_y_file_streams_as_column(self, files, tmp_path):
        """A (N,) y .npy — the library-wide M=1 convention — must work
        on the binary ingest path (streams as (N, 1))."""
        xp, _, X, Y = files
        y1 = str(tmp_path / "y1d.npy")
        np.save(y1, Y[:, 0])  # genuinely 1-D on disk
        assert npy_shape(y1)[0] == (500,)
        acc = stats_from_npy(xp, y1)
        np.testing.assert_allclose(
            np.asarray(acc.XY)[:, 0], X.T @ Y[:, 0], rtol=2e-5
        )
        assert acc.XY.shape == (24, 1)

    def test_direct_without_pool_raises(self, files):
        xp, _, _, _ = files
        with pytest.raises(ValueError, match="reuse_buffers"):
            next(stream_npy(xp, 100, direct=True))

    def test_empty_chunk_iterable_raises(self, tmp_path):
        with pytest.raises(ValueError, match="empty chunk iterable"):
            write_npy_chunked(str(tmp_path / "e.npy"), iter([]))

    def test_out_of_range_assignments_raise(self, files):
        from pls_tpu.utils.binio import fold_stats_from_npy

        xp, yp, _, _ = files
        bad = np.full(500, 7, np.int32)  # k=2 but labels say fold 7
        with pytest.raises(ValueError, match=r"\[0, 2\)"):
            fold_stats_from_npy(xp, yp, bad, 2)

    def test_stats_precision_highest_accepted(self, files):
        """The stats_precision knob reaches the accumulation (on CPU the
        result is identical to default; the knob matters on a GPU where
        default f32 matmuls run in TF32)."""
        xp, yp, X, Y = files
        a0 = stats_from_npy(xp, yp)
        a1 = stats_from_npy(xp, yp, stats_precision="highest")
        np.testing.assert_allclose(
            np.asarray(a0.XX), np.asarray(a1.XX), rtol=1e-6
        )
