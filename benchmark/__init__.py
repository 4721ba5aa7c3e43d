"""The benchmark of ``dgraph_tpu_torch``: cells on one H100, or on four.

One run of one cell, from the root of a checkout:

    python -m benchmark.run --workload synth21m.fanout4096 --seed 1 \
        --seconds 10 --trace 0

``BENCHMARK.json`` at the root names the cells, their configurations
(``benchmark/configs/<name>.json``), their traffic mixes
(``benchmark/traffic/<name>.json``) and the metrics, each read by
``benchmark/metrics/<name>.py``.  A configuration's graph is made by
``benchmark/generators/<generator>.py``, a mix's pool of queries by
``benchmark/pool_laws/<pool_law>.py``.  A mix's timed loop is the driver
it names, ``benchmark/drivers/<driver>.py`` (``batched_2hop`` where it names
none), which gets the cell's cards; a cell's size for the CPU tests is
``benchmark/tiny/<cell>.json``.  A new cell, configuration, mix, driver or
metric is a new file and a new entry; the harness finds it by name
(``benchmark/spec.py``, which also states what a driver returns).

Everything that judges the program lives here and imports nothing of it:
the data and traffic generators (``data.py``), the plain numpy reference
(``reference.py``), the comparison and its limits (``compare.py``), the
reduction of profiler traces (``trace.py``) and the table of peaks with
the kernels' byte counts (``roofline.py``).  Only the drivers import the
program, to drive it.
"""
