// golden_gen.cpp — fixture generator for the pls-tpu parity test suite.
//
// This is NEW code (not copied from the reference): it merely #includes the
// reference library headers (/root/reference/include/PLS/pls.h) and calls its
// public API to dump ground-truth values at full double precision, so the
// JAX reimplementation can be tested against the reference to 1e-12.
//
// Usage: golden_gen <X.csv> <Y.csv> <ncomp> <lso_trials> <outdir> <prefix>
// Also dumps RNG fixtures (std::mt19937 raw draws + libstdc++ std::shuffle
// traces) used to validate the pure-Python GCC-RNG compatibility emulator.

#include <PLS/pls.h>
#include <fstream>
#include <iomanip>
#include <random>
#include <string>
#include <vector>
#include <complex>
#include <iostream>
#include <numeric>
#include <algorithm>

using namespace PLS;

static void dump_real(const Mat2D &m, const std::string &path) {
    std::ofstream f(path);
    f << std::setprecision(17);
    for (Eigen::Index i = 0; i < m.rows(); i++) {
        for (Eigen::Index j = 0; j < m.cols(); j++) {
            if (j) f << ",";
            f << m(i, j);
        }
        f << "\n";
    }
}

static void dump_complex_real_part(const Mat2Dc &m, const std::string &path) {
    // verify imaginary parts are negligible, then dump real parts
    double max_imag = 0;
    for (Eigen::Index i = 0; i < m.rows(); i++)
        for (Eigen::Index j = 0; j < m.cols(); j++)
            max_imag = std::max(max_imag, std::abs(std::imag(m(i, j))));
    if (max_imag > 1e-9) {
        std::cerr << "WARNING: " << path << " max |imag| = " << max_imag << "\n";
    }
    dump_real(m.real(), path);
}

static void dump_row(const Row &r, const std::string &path) {
    Mat2D m(1, r.size());
    m.row(0) = r;
    dump_real(m, path);
}

int main(int argc, char **argv) {
    if (argc != 7) {
        std::cerr << "usage: golden_gen X.csv Y.csv ncomp lso_trials outdir prefix\n";
        return 2;
    }
    const std::string xfile = argv[1], yfile = argv[2];
    const size_t ncomp = std::stoul(argv[3]);
    const size_t lso_trials = std::stoul(argv[4]);
    const std::string outdir = argv[5], prefix = argv[6];
    auto path = [&](const std::string &name) { return outdir + "/" + prefix + "_" + name + ".csv"; };

    Mat2D X_orig = read_matrix_file(xfile);
    Mat2D Y_orig = read_matrix_file(yfile);
    Mat2D X = colwise_z_scores(X_orig);
    Mat2D Y = colwise_z_scores(Y_orig);
    dump_real(X, path("Xz"));
    dump_real(Y, path("Yz"));

    // ----- Type 1 fit -----
    Model m1(X, Y, KERNEL_TYPE1, ncomp);
    dump_complex_real_part(m1.coefficients(), path("B"));
    dump_complex_real_part(m1.scores(X), path("T"));
    {
        // explained variance + SSE for every truncation 1..A
        Mat2D ev(ncomp, Y.cols()), sse(ncomp, Y.cols());
        for (size_t c = 1; c <= ncomp; c++) {
            ev.row(c - 1) = m1.explained_variance(X, Y, c);
            sse.row(c - 1) = m1.SSE(X, Y, c);
        }
        dump_real(ev, path("ev"));
        dump_real(sse, path("sse"));
        // per-truncation coefficients for c=1 (checks cumulative structure)
        dump_complex_real_part(m1.coefficients(1), path("B1"));
    }

    // ----- Type 2 fit (same data) -----
    Model m2(X, Y, KERNEL_TYPE2, ncomp);
    dump_complex_real_part(m2.coefficients(), path("t2_B"));

    // ----- LOO CV -----
    {
        Residual loo = m1.cv_LOO();
        auto errs = loo.errors();
        for (size_t k = 0; k < errs.size(); k++)
            dump_real(errs[k], path("loo_resid_y" + std::to_string(k)));
        dump_real(validation(loo, MSE).cwiseSqrt(), path("loo_rmse"));
        dump_real(validation(loo, RESS), path("loo_press"));
        Colsz opt = optimal_num_components(loo);
        Mat2D optm(1, opt.size());
        for (Eigen::Index i = 0; i < opt.size(); i++) optm(0, i) = (double)opt[i];
        dump_real(optm, path("loo_opt"));

        // wilcoxon p-values between all pairs of LOO error columns of y0
        const Mat2D &e0 = errs[0];
        Mat2D wil(ncomp, ncomp);
        for (size_t i = 0; i < ncomp; i++)
            for (size_t j = 0; j < ncomp; j++)
                wil(i, j) = wilcoxon(e0.col(i), e0.col(j));
        dump_real(wil, path("wilcoxon"));
    }

    // ----- new-data CV (predict second half from fit on all) -----
    {
        Eigen::Index half = X.rows() / 2;
        Residual nd = m1.cv_NEW_DATA(X.bottomRows(half), Y.bottomRows(half));
        auto errs = nd.errors();
        for (size_t k = 0; k < errs.size(); k++)
            dump_real(errs[k], path("newdata_resid_y" + std::to_string(k)));
    }

    // ----- LSO CV (frac 0.3, default-seeded mt19937 as the CLI does) -----
    {
        // first record the partitions the reference RNG generates, by
        // replaying an identical RNG alongside
        const size_t N = X.rows();
        const size_t test_size = static_cast<size_t>(0.3 * N + 0.5);
        const size_t train_size = N - test_size;
        std::mt19937 rng_trace;
        std::vector<Eigen::Index> sample(train_size), complement(test_size),
            full(N);
        std::iota(full.begin(), full.end(), 0);
        std::ofstream pf(path("lso_parts"));
        for (size_t rep = 0; rep < lso_trials; rep++) {
            rand_nchoosek(rng_trace, full, sample, complement);
            for (size_t i = 0; i < N; i++) {
                if (i) pf << ",";
                pf << full[i];
            }
            pf << "\n";
        }
        pf.close();

        std::mt19937 rng;
        Residual lso = m1.cv_LSO(0.3, lso_trials, rng);
        auto errs = lso.errors();
        for (size_t k = 0; k < errs.size(); k++)
            dump_real(errs[k], path("lso_resid_y" + std::to_string(k)));
        dump_real(validation(lso, MSE).cwiseSqrt(), path("lso_rmse"));
        Colsz opt = optimal_num_components(lso);
        Mat2D optm(1, opt.size());
        for (Eigen::Index i = 0; i < opt.size(); i++) optm(0, i) = (double)opt[i];
        dump_real(optm, path("lso_opt"));
    }

    // ----- scalar function fixtures (dataset-independent; harmless to rewrite) -----
    {
        std::ofstream f(outdir + "/normalcdf.csv");
        f << std::setprecision(17);
        for (int i = -50; i <= 50; i++) {
            double z = i / 10.0;
            f << z << "," << normalcdf(z) << "\n";
        }
    }
    {
        // raw mt19937 draws, default seed
        std::mt19937 g;
        std::ofstream f(outdir + "/mt19937_raw.csv");
        for (int i = 0; i < 2000; i++) f << g() << "\n";
    }
    {
        // libstdc++ std::shuffle traces for various sizes
        for (size_t n : {10, 60, 7, 128}) {
            std::mt19937 g;
            std::vector<int> v(n);
            std::iota(v.begin(), v.end(), 0);
            std::ofstream f(outdir + "/shuffle" + std::to_string(n) + ".csv");
            for (int rep = 0; rep < 8; rep++) {
                std::shuffle(v.begin(), v.end(), g);
                for (size_t i = 0; i < n; i++) {
                    if (i) f << ",";
                    f << v[i];
                }
                f << "\n";
            }
        }
    }

    std::cerr << "golden fixtures written to " << outdir << " (prefix " << prefix << ")\n";
    return 0;
}
