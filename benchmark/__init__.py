"""The benchmark of ``multimodal_baby_tpu_torch`` on NVIDIA GPUs
(``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``). Cells, configurations, traffic mixes, metric readers and
limits are files found by name; see ``harness.py``."""
