"""The benchmark of ``dem_engine_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: the configuration
and traffic files it names, the window of ``DEMSolver.DoDynamics``
frames, the readers of ``metrics/`` on a traced run, and the check of
the outputs against ``reference/``.
"""
