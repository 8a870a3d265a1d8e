"""The benchmark of the PyTorch and CUDA port (``kube_sqs_autoscaler_tpu_torch``).

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
"""
