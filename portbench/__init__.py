"""The benchmark of ``sutro_tpu_torch`` on an NVIDIA H100: billed tokens a
second of batch jobs through the port's ``LocalEngine``, its set-up time,
per-layer metrics from spans and the device trace, and a check of the
served tokens against a plain float32 reference. ``BENCHMARK.json`` at the
repository's root lists the cells; ``python3 -m portbench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one.
"""
