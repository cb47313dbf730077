"""The plain references, which import nothing of the port: ``osqp_f64`` (a
frozen copy of the repository's f64_oracle.py, NumPy/SciPy, one QP at a
time) and ``osqp_batched``, the same iteration in plain torch over a fleet,
held to ``osqp_f64`` in float64 by the tests, which the control runs at TF32
in the program's place."""
