# Developer entry points for pls-tpu.
#
# Mirrors the intent of the reference's Makefile (upstream Makefile)
# but for a Python/JAX project: build native bits, test, bench, regenerate
# golden parity fixtures.

.PHONY: native predictor test test-fast nan-check bench golden clean gpu-test ingest-bench

native:
	python setup.py build_ext --inplace

predictor:
	g++ -std=c++17 -O2 -o pls_predict native/pls_predict_main.cpp

test:
	python -m pytest tests/ -x -q

test-fast:
	python -m pytest tests/ -x -q -m "not slow"

# NaN-sanitizer pass: the whole fast suite under jax_debug_nans — every
# jitted program re-checked for silent NaN production (utils/debug.py
# provides the scoped context manager for library use).
nan-check:
	JAX_DEBUG_NANS=1 python -m pytest tests/ -x -q -m "not slow"

bench:
	python bench.py

# On-card check of the main path: CLI parity, kernel exactness against
# f64, the multi-response fit and the out-of-core k-fold (one GPU).
gpu-test:
	python chip_smoke.py

# Disk-fed north-star measurement (benchmarks/ingest_bench.py), one
# process per phase; the 40 GB dataset generates once into $(NS_DATA)
# and is reused.
NS_DATA ?= .ns_data
NS_ART ?= benchmarks/results/ingest_northstar.json
ingest-bench:
	python benchmarks/ingest_bench.py --datadir $(NS_DATA) --phase probe --out $(NS_ART)
	python benchmarks/ingest_bench.py --datadir $(NS_DATA) --phase stats --out $(NS_ART)
	python benchmarks/ingest_bench.py --datadir $(NS_DATA) --phase cv --out $(NS_ART)
	python benchmarks/ingest_bench.py --datadir $(NS_DATA) --phase kfold --kfold 10 --out $(NS_ART)

golden:
	tools/gen_golden.sh

clean:
	rm -rf build pls_predict pls_tpu/_native*.so pls_tpu/__pycache__ */__pycache__
