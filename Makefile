# Top-level developer / CI entry points.
#
# The test suite is hermetic on CPU: tests/conftest.py selects the CPU
# backend with 8 virtual devices (XLA_FLAGS), so `make ci` needs no GPU —
# the multi-device shard_map ring path runs on the virtual mesh
# (SURVEY.md §4 "Implication for the rebuild").  On the GPU,
# `python chip_smoke.py` drives the main path once at real sizes.

PYTHON ?= python

.PHONY: ci test native bench clean

ci: native test

test:
	$(PYTHON) -m pytest tests/ -q

native:
	$(MAKE) -C native

bench:
	$(PYTHON) bench.py

clean:
	$(MAKE) -C native clean
