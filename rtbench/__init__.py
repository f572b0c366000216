"""The benchmark of raytracingengine_tpu_torch: one cell per run
(`python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`).

Nothing here imports JAX or the JAX package; `reference/` imports nothing
of the package under test either.
"""
