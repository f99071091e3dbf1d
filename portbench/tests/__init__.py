"""CPU tests of the benchmark (and, marked ``gpu``, its runs on the card):
``python -m pytest portbench/tests -q``."""
