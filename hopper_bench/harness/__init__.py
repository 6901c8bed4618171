"""The harness: names from BENCHMARK.json resolved to files, the cells'
drivers, the trace reader."""
