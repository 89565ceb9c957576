"""The benchmark of the PyTorch/CUDA port (``super_resolution_tpu_torch``):
``python3 -m sr_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. ``BENCHMARK.json`` at the repository root names the cells;
each configuration, traffic mix, correctness limit and per-layer metric is
a file of its own under this folder, found by its name."""
