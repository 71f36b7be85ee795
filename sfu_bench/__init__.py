"""The benchmark of the PyTorch and CUDA port (`livekit_server_tpu_torch`).

Run one cell: `python3 sfu_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the checkout's root (README.md).
"""
