"""CPU tests of the benchmark (and one card test, marked ``gpu``):
``python -m pytest benchmark/tests -q`` from the repository's root."""
