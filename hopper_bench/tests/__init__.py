"""CPU tests of the benchmark: python -m pytest hopper_bench/tests -q (from the
checkout's root)."""
