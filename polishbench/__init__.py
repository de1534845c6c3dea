"""The benchmark of the PyTorch and CUDA polisher (nextpolish2_tpu_torch):
whole-assembly polish passes on seeded inputs, checked against a plain
reference. Entry point: polishbench/run.py."""
