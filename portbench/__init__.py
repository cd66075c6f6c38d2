"""portbench: the benchmark of ``rectpu_torch``, the PyTorch and CUDA port.

Run one cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (or ``python3 -m portbench``) from the root of
a checkout; ``BENCHMARK.json`` names the cells. It imports neither JAX nor
the JAX package.
"""
