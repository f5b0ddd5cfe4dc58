"""The benchmark of the PyTorch and CUDA port (``dmft_lanc_ed_tpu_torch``):
one DMFT cell a run on one H100, checked against a plain NumPy/SciPy
reference. Run ``python3 edbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root."""
