"""The benchmark of quadraticprogramsolver_tpu_torch on one NVIDIA H100.

``python3 qpbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything a cell needs is found by name: the configuration in
``configs/``, the traffic mix in ``workloads/``, the generators in
``traffic/``, the plain reference in ``reference/`` and one reader a metric in
``metrics/``. Nothing here imports jax or the JAX package; ``traffic/`` and
``reference/`` import nothing of the port either.
"""
