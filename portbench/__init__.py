"""The benchmark of the PyTorch and CUDA port (`sednet_tpu_torch`):
`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`. See README.md."""
