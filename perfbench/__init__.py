"""The benchmark of ``lp_gnn_tpu_torch``: full-graph training on one
NVIDIA H100, in cells that read their configuration, traffic, limits and
per-layer metrics from files under this folder.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``BENCHMARK.json`` at the root of the repository lists the cells and the
metrics. Everything that measures lives here and imports nothing of the
program but what ``system.py`` drives: the traffic generator
(``lpgen.py``, with ``mirp.py``), the weights' draw (``weights.py``), the
trace's reduction (``trace.py``, ``metrics/``), the counts of bytes and
operations (``counts/``), the table of peaks (``peaks.json``), the plain
references (``reference/``) and the comparison that decides ``correct``
(``check.py``, ``limits/``).
"""
