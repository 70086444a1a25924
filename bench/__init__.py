"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``
(``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``) and prints one JSON result line. Configurations, traffic
mixes and the streams that read them, metric readers and kernel counts
are files found by name."""
