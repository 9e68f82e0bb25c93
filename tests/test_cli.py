"""CLI contract tests (reference: upstream src/main.cpp:10-44).

Runs `python -m pls_tpu` in a subprocess (CPU, x64) and checks exit codes,
stderr layout, and numeric parity of every reported table against the
captured reference CLI stderr (tests/golden/*_cli_stderr.txt).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
REF = REPO / "pls_tpu" / "data"


_XLA_LOG = re.compile(r"^(?:[EWIF]\d{4} |WARNING:)")


def run_cli(*args, timeout=900):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "pls_tpu", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout,
    )
    # XLA's C++ runtime may interleave glog lines (e.g. cpu_aot_loader
    # notices when the persistent compile cache was built on another
    # machine) into stderr; they are not CLI output — drop them before
    # parsing the report tables.
    r.stderr = "".join(
        ln for ln in r.stderr.splitlines(keepends=True) if not _XLA_LOG.match(ln)
    )
    return r


def test_bad_argc_exits_100():
    r = run_cli("only_one_arg", timeout=120)
    assert r.returncode == 100
    assert "Usage: ./pls X_data.csv Y_data.csv num_components" in r.stderr


def test_ragged_csv_exits_1(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n4,5\n")
    y = tmp_path / "y.csv"
    y.write_text("1\n2\n")
    r = run_cli(str(bad), str(y), "1", timeout=120)
    assert r.returncode == 1
    # the reference's exact diagnostic (pls.cpp:56)
    assert (
        "Error: row 1 has 2 columns, but previous row(s) have 3 columns."
        in r.stderr
    )


def test_missing_file_errors(tmp_path):
    r = run_cli(str(tmp_path / "nope.csv"), str(tmp_path / "nope2.csv"), "1",
                timeout=120)
    assert r.returncode == 1


def _parse_labeled_matrix(text: str, label: str) -> np.ndarray:
    """Parse a 'label:\\n<rows...>' block of floats from CLI stderr."""
    lines = text.split("\n")
    idx = lines.index(f"{label}:")
    rows = []
    for line in lines[idx + 1:]:
        vals = line.split()
        try:
            rows.append([float(v) for v in vals])
        except ValueError:
            break
        if not vals:
            break
    return np.asarray(rows)


def _parse_ref_complex_matrix(text: str, label: str) -> np.ndarray:
    """Parse Eigen's complex '(re,im)' matrix from the reference stderr."""
    lines = text.split("\n")
    idx = lines.index(f"{label}:")
    rows = []
    pat = re.compile(r"\(([-+0-9.e]+),[-+0-9.e]+\)")
    for line in lines[idx + 1:]:
        vals = pat.findall(line)
        if not vals:
            break
        rows.append([float(v) for v in vals])
    return np.asarray(rows)


@pytest.fixture(scope="module")
def toy_run():
    r = run_cli(str(REF / "toyX.csv"), str(REF / "toyY.csv"), "2")
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def test_stdout_empty(toy_run):
    # all report output goes to stderr (pls.h:158,245,248)
    assert toy_run.stdout == ""


def test_state_tables_match_reference(toy_run):
    gold_text = (GOLDEN / "toy_cli_stderr.txt").read_text()
    for label in ["P", "W", "R", "Q", "T", "coefficients"]:
        ref = _parse_ref_complex_matrix(gold_text, label)
        mine = _parse_labeled_matrix(toy_run.stderr, label)
        assert mine.shape == ref.shape, label
        # 6-sig-digit prints; allow per-column sign flips
        signs = np.sign(np.sum(mine * ref, axis=0))
        signs[signs == 0] = 1
        np.testing.assert_allclose(mine * signs, ref, rtol=2e-5, atol=1e-5,
                                   err_msg=label)


def test_explained_variance_lines(toy_run):
    gold_text = (GOLDEN / "toy_cli_stderr.txt").read_text()
    pat = re.compile(
        r"(\d+) components explained variance:\s+(\S+)\s+(\S+)\s+- SSE:\s+(\S+)\s+(\S+)"
    )
    ref = {m.group(1): [float(m.group(i)) for i in (2, 3, 4, 5)]
           for m in pat.finditer(gold_text)}
    mine = {m.group(1): [float(m.group(i)) for i in (2, 3, 4, 5)]
            for m in pat.finditer(toy_run.stderr)}
    assert set(ref) == set(mine) == {"1", "2"}
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=2e-5)


def test_validation_blocks_match_reference(toy_run):
    gold_text = (GOLDEN / "toy_cli_stderr.txt").read_text()

    def grab(text, method):
        m = re.search(
            rf"{method} Validation:\nRMSE  Matrix \(rows = Y variable; cols = # of components\):\n"
            rf"(.*?)\nOptimal number of components \(by Y variable\):\t(\d+)\n(\d+)",
            text, re.S,
        )
        assert m, f"{method} block missing"
        mat = np.asarray([[float(v) for v in ln.split()] for ln in m.group(1).split("\n")])
        return mat, (int(m.group(2)), int(m.group(3)))

    for method in ["LOO", "LSO"]:
        ref_mat, ref_opt = grab(gold_text, method)
        my_mat, my_opt = grab(toy_run.stderr, method)
        np.testing.assert_allclose(my_mat, ref_mat, rtol=2e-5, err_msg=method)
        assert my_opt == ref_opt, method


def test_json_report_and_cv_flags(tmp_path):
    """--cv loo --json writes the structured report; LSO skipped."""
    import json

    out = tmp_path / "report.json"
    r = run_cli(
        str(REF / "toyX.csv"), str(REF / "toyY.csv"), "2",
        "--cv", "loo", "--json", str(out),
    )
    assert r.returncode == 0, r.stderr[-1500:]
    assert "LSO Validation:" not in r.stderr
    rep = json.loads(out.read_text())
    assert rep["num_components"] == 2
    assert rep["loo_optimal_components"] == [2, 1]
    np_rmse = rep["loo_rmse"]
    assert abs(np_rmse[0][0] - 0.791811) < 1e-4
    assert "lso_rmse" not in rep


def test_kfold_cv_flag(tmp_path):
    """--cv kfold (framework extension) prints the k-FOLD validation
    block and records it in the JSON report; LOO/LSO skipped."""
    import json

    out = tmp_path / "report.json"
    r = run_cli(
        str(REF / "toyX.csv"), str(REF / "toyY.csv"), "2",
        "--cv", "kfold", "--kfold-k", "5", "--json", str(out),
    )
    assert r.returncode == 0, r.stderr[-1500:]
    assert "5-FOLD Validation:" in r.stderr
    assert "LOO Validation:" not in r.stderr
    rep = json.loads(out.read_text())
    assert rep["kfold_k"] == 5
    assert len(rep["kfold_rmse"]) == 2  # (M, A) rows
    assert all(1 <= c <= 2 for c in rep["kfold_optimal_components"])


def test_alpha_flag_changes_selection():
    """The selector accepts a smaller model when its Wilcoxon p-value
    exceeds α (pls.cpp:283).  α = 1e-9 makes every smaller candidate pass,
    so the optimum collapses to 1 component for every response — a
    different answer than the default α=0.1 run's (2, 1)."""
    r = run_cli(
        str(REF / "toyX.csv"), str(REF / "toyY.csv"), "2",
        "--cv", "loo", "--alpha", "1e-9",
    )
    assert r.returncode == 0, r.stderr[-1500:]
    block = r.stderr.split("LOO Validation:")[1]
    opt = block.split("Optimal number of components (by Y variable):\t")[1]
    vals = [int(v) for v in opt.strip().split("\n")[:2]]
    assert vals == [1, 1]


def test_eigen_complex_format_byte_parity_nir():
    """--format eigen-complex reproduces the reference CLI's state dump
    BYTE-FOR-BYTE on nir (M=1: no eigenvector sign ambiguity) — 1671
    lines of P/W/R/Q/T/coefficients in Eigen's complex-tuple layout."""
    r = run_cli(
        str(REF / "nir.csv"), str(REF / "octane.csv"), "10",
        "--cv", "none", "--format", "eigen-complex",
    )
    assert r.returncode == 0, r.stderr[-1500:]

    def state_block(text):
        lines = text.split("\n")
        start = lines.index("P:")
        end = next(i for i, l in enumerate(lines) if "components explained" in l)
        return lines[start:end]

    ref = state_block((GOLDEN / "nir_cli_stderr.txt").read_text())
    mine = state_block(
        "\n".join(
            l for l in r.stderr.split("\n")
            if "WARNING" not in l and "cpu_aot" not in l and not l.startswith("E0")
        )
    )
    assert mine == ref


def test_cli_preprocess_flag(tmp_path, capfd):
    """--preprocess applies the spectral chain before z-scoring (results
    differ from the plain run but the pipeline completes normally)."""
    import numpy as np

    from pls_tpu.cli import main

    rng = np.random.default_rng(0)
    X = rng.normal(size=(20, 24)).cumsum(axis=1)
    y = X[:, 5] + 0.1 * rng.normal(size=20)
    xf, yf = str(tmp_path / "x.csv"), str(tmp_path / "y.csv")
    np.savetxt(xf, X, delimiter=",")
    np.savetxt(yf, y[:, None], delimiter=",")
    rc = main([xf, yf, "2", "--cv", "none",
               "--preprocess", "savgol:7:2:1,snv"])
    assert rc == 0
    err = capfd.readouterr().err
    assert "explained variance" in err
    rc = main([xf, yf, "2", "--cv", "none", "--preprocess", "bogus"])
    assert rc == 1


class TestNpyInput:
    def test_cli_accepts_npy_files(self, tmp_path, golden, capsys):
        """Production .npy inputs flow through the same pipeline: same
        numbers as the CSV path on identical data."""
        import numpy as np

        from pls_tpu.cli import main

        X = golden("toy_Xz")
        Y = golden("toy_Yz")
        xnpy = str(tmp_path / "x.npy")
        ynpy = str(tmp_path / "y.npy")
        np.save(xnpy, X)
        np.save(ynpy, Y[:, 0])  # 1-D y: treated as one column
        rc = main([xnpy, ynpy, "2", "--cv", "none", "--preprocess", ""])
        assert rc == 0
        err = capsys.readouterr().err
        assert "components explained variance" in err
