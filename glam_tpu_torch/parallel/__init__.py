"""The parallel layer of the port: ranks and their process group
(``distributed``), data parallelism (``data_parallel``), the graph
partition and its halo message steps (``graph_partition``) and the
scaling harness (``bench_scaling``)."""
