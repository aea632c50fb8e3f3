"""CPU and card tests of the benchmark (python -m pytest portbench/tests)."""
