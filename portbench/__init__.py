"""portbench: the benchmark of ``dvf_tpu_torch`` on one NVIDIA H100.

One command runs one cell once::

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name (``BENCHMARK.json`` at the checkout root,
``cells/<cell>.json``, ``configs/<config>.json``, ``traffic/<driver>.py``,
``end_to_end/<metric>.py``, ``layer_metrics/<metric>.py``,
``counts/<name>.py``), so a cell, a configuration or a metric is added as
new files only. The yardstick (traffic, window arithmetic, trace reduction,
peaks, counts and the plain reference that decides ``correct``) lives here;
from the program the benchmark takes only the system under test and its
counters.
"""
