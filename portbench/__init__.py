"""The benchmark of vectorgraphlibrary_tpu_torch on one NVIDIA H100.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once. README.md gives the
file layout and how a configuration, mix, job kind or metric is added.
"""
