"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``portbench/run.py`` runs one cell of ``BENCHMARK.json``; everything a
cell needs is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/`` (read by the generator it names in
``generators/``), its per-metric readers in ``metrics/`` and the limits of
its correctness comparison in ``limits/``.  ``yardstick/`` and
``reference/`` hold what the program may not change: the data
generators, the card's figures and each kernel's work, the trace
reduction and the plain references that decide ``correct``.
"""
