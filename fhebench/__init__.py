"""The benchmark of abc_tpu_torch on one NVIDIA H100: encrypted DSL programs
served through one captured CUDA graph. `python3 -m fhebench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>` runs one cell once; README.md
has the layout."""
