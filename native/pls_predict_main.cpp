// pls_predict — native serving CLI for PLSB models exported by
// pls_tpu.export.export_model_c.
//
// The reference library ships a C++ API intended for embedding in larger
// simulations (/root/reference/README.md:11-14); this tool is the
// standalone serving analogue for the accelerator-trained framework: train/tune
// on a GPU in Python, export once, then predict anywhere a C++17 compiler
// runs — no Python, no JAX, no Eigen.
//
// Usage:  pls_predict model.plsb X.csv
//
// For each CSV row (raw units; no header) prints
//     yhat_1 ... yhat_M | t2 spe ok
// where t2/spe are the Hotelling-T² / squared-prediction-error monitor
// statistics and ok is the in-control flag (1 when the model was
// exported without a monitor).  Build: `make predictor` (repo root) or
//     g++ -std=c++17 -O2 -o pls_predict native/pls_predict_main.cpp
//
// tests/test_native_consumer.py compiles THIS file and asserts numeric
// agreement with the Python estimator.

#include "pls_predict.hpp"

#include <cstdio>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

int main(int argc, char **argv) {
    if (argc != 3) {
        std::fprintf(stderr,
                     "usage: %s model.plsb X.csv\n"
                     "  model.plsb : exported via pls_tpu.export_model_c\n"
                     "  X.csv      : raw-unit rows, comma-separated, no header\n",
                     argv[0]);
        return 2;
    }
    pls::Model m;
    try {
        m = pls::Model::load(argv[1]);
    } catch (const std::exception &e) {
        std::fprintf(stderr, "error loading %s: %s\n", argv[1], e.what());
        return 1;
    }
    std::ifstream f(argv[2]);
    if (!f) {
        std::fprintf(stderr, "error: cannot open %s\n", argv[2]);
        return 1;
    }
    std::string line;
    size_t row = 0;
    while (std::getline(f, line)) {
        if (line.empty()) continue;
        std::vector<double> x;
        std::stringstream ss(line);
        std::string cell;
        while (std::getline(ss, cell, ',')) {
            try {
                x.push_back(std::stod(cell));
            } catch (const std::exception &) {
                std::fprintf(stderr, "error: row %zu: bad number '%s'\n",
                             row + 1, cell.c_str());
                return 1;
            }
        }
        if (x.size() != static_cast<size_t>(m.K())) {
            std::fprintf(stderr,
                         "error: row %zu has %zu columns, model expects %lld\n",
                         row + 1, x.size(),
                         static_cast<long long>(m.K()));
            return 1;
        }
        auto y = m.predict(x);
        auto c = m.check(x);
        for (double v : y) std::printf("%.12e ", v);
        std::printf("| %.12e %.12e %d\n", c.t2, c.spe, c.ok ? 1 : 0);
        ++row;
    }
    return 0;
}
