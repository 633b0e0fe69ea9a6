"""The benchmark of the PyTorch and CUDA port of KCCOT-GAN on the H100.

``python3 -m port_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.  Everything a cell needs is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json`` (whose
``driver`` names a module of ``drivers/``), ``limits/<workload>.json``
and, per per-layer metric, ``metrics/<metric>.py``.  The yardstick
(traffic generation, work and roofline arithmetic, trace reading, the
plain reference and the comparison that decides ``correct``) lives here,
apart from the program under test.
"""
