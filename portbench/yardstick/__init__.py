"""Frozen parts of the benchmark: generators, work counts, statistics and
the profiler trace's reduction.  Nothing here imports the program."""
