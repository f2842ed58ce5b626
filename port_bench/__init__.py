"""The benchmark of ``clip_embeds_tpu_torch`` on one NVIDIA H100.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration in
``configs/``, its traffic in ``traffic/``, the driver of the traffic's kind
in ``drivers/``, each per-layer metric's reader in ``metrics/`` and each
cell's correctness limits in ``limits/``. ``reference/`` is the plain fp32
PyTorch the outputs are judged against; it imports nothing of the port.
"""
