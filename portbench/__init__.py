"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and
prints its result as the last line of standard output.  Everything a
cell needs is found by name: its configuration in ``configs/``, its
traffic in ``traffic/``, the driver the traffic names in ``drivers/``,
the plain reference of the configuration's family in ``reference/``,
its output limits in ``limits/`` and each per-layer metric in
``metrics/``.
"""
