// pls_predict.hpp — header-only C++17 loader/predictor for models trained
// by pls-tpu and exported with pls_tpu.export.export_model_c (PLSB format).
//
// The reference library is itself designed to be embedded in larger C++
// simulations (/root/reference/README.md:11-14).  This header closes the
// same loop for the accelerator-trained framework: a consumer links NO Python, NO
// JAX, NO Eigen — just this header — and gets raw-unit prediction, latent
// scores, and the T²/SPE admission gate of a calibrated model.
//
//   #include "pls_predict.hpp"
//   auto m = pls::Model::load("model.plsb");
//   std::vector<double> yhat = m.predict(x);       // x.size() == m.K()
//   pls::Check c = m.check(x);                     // T²/SPE gate
//
// New code (not derived from the reference's sources); format doc in
// pls_tpu/export.py.

#pragma once

#include <cstdint>
#include <cstring>
#include <fstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace pls {

struct Check {
    double t2 = 0.0;
    double spe = 0.0;
    bool t2_ok = true;
    bool spe_ok = true;
    bool ok = true;       // both in control
    bool has_limits = false;  // model was exported with a monitor
};

class Model {
  public:
    static Model load(const std::string &path) {
        std::ifstream f(path, std::ios::binary);
        if (!f) throw std::runtime_error("pls: cannot open " + path);
        char magic[8];
        f.read(magic, 8);
        if (!f || std::memcmp(magic, "PLSTPU01", 8) != 0)
            throw std::runtime_error("pls: bad magic in " + path);
        Model m;
        m.k_ = read_i64(f);
        m.m_ = read_i64(f);
        m.a_ = read_i64(f);
        if (m.k_ <= 0 || m.m_ <= 0 || m.a_ <= 0 || m.a_ > m.k_)
            throw std::runtime_error("pls: corrupt header in " + path);
        read_f64(f, m.x_mean_, m.k_);
        read_f64(f, m.B_, m.k_ * m.m_);
        read_f64(f, m.b0_, m.m_);
        read_f64(f, m.R_, m.k_ * m.a_);
        read_f64(f, m.P_, m.k_ * m.a_);
        read_f64(f, m.x_std_, m.k_);
        read_f64(f, m.s2_, m.a_);
        double lims[2];
        f.read(reinterpret_cast<char *>(lims), sizeof lims);
        if (!f) throw std::runtime_error("pls: truncated file " + path);
        m.t2_lim_ = lims[0];
        m.spe_lim_ = lims[1];
        return m;
    }

    std::int64_t K() const { return k_; }
    std::int64_t M() const { return m_; }
    std::int64_t A() const { return a_; }

    // ŷ (length M) for one raw-unit sample x (length K):
    //   ŷ = (x − x_mean)·B + b0
    std::vector<double> predict(const std::vector<double> &x) const {
        require_k(x);
        std::vector<double> y(b0_);
        for (std::int64_t k = 0; k < k_; ++k) {
            const double xc = x[k] - x_mean_[k];
            const double *row = &B_[k * m_];
            for (std::int64_t j = 0; j < m_; ++j) y[j] += xc * row[j];
        }
        return y;
    }

    // latent scores t (length A):  t = (x − x_mean)·R_raw
    std::vector<double> scores(const std::vector<double> &x) const {
        require_k(x);
        std::vector<double> t(a_, 0.0);
        for (std::int64_t k = 0; k < k_; ++k) {
            const double xc = x[k] - x_mean_[k];
            const double *row = &R_[k * a_];
            for (std::int64_t a = 0; a < a_; ++a) t[a] += xc * row[a];
        }
        return t;
    }

    // T²/SPE admission gate (models/diagnostics.py semantics).  If the
    // model was exported without a monitor, statistics are computed but
    // has_limits=false and ok stays true.
    Check check(const std::vector<double> &x) const {
        const std::vector<double> t = scores(x);
        Check c;
        c.has_limits = (t2_lim_ > 0.0 || spe_lim_ > 0.0);
        for (std::int64_t a = 0; a < a_; ++a) c.t2 += t[a] * t[a] / s2_[a];
        // SPE in scaled units: ‖(x−μ)/σ − t Pᵀ‖²
        for (std::int64_t k = 0; k < k_; ++k) {
            double e = (x[k] - x_mean_[k]) / x_std_[k];
            const double *row = &P_[k * a_];
            for (std::int64_t a = 0; a < a_; ++a) e -= t[a] * row[a];
            c.spe += e * e;
        }
        if (c.has_limits) {
            c.t2_ok = c.t2 <= t2_lim_;
            c.spe_ok = c.spe <= spe_lim_;
            c.ok = c.t2_ok && c.spe_ok;
        }
        return c;
    }

  private:
    static std::int64_t read_i64(std::ifstream &f) {
        std::int64_t v = 0;
        f.read(reinterpret_cast<char *>(&v), sizeof v);
        return v;
    }
    static void read_f64(std::ifstream &f, std::vector<double> &dst,
                         std::int64_t n) {
        dst.resize(static_cast<std::size_t>(n));
        f.read(reinterpret_cast<char *>(dst.data()),
               static_cast<std::streamsize>(n * 8));
        if (!f) throw std::runtime_error("pls: truncated model file");
    }
    void require_k(const std::vector<double> &x) const {
        if (static_cast<std::int64_t>(x.size()) != k_)
            throw std::invalid_argument("pls: sample length != K");
    }

    std::int64_t k_ = 0, m_ = 0, a_ = 0;
    std::vector<double> x_mean_, B_, b0_, R_, P_, x_std_, s2_;
    double t2_lim_ = 0.0, spe_lim_ = 0.0;
};

}  // namespace pls
