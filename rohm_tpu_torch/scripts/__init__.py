"""Scripts. `make_eval_noise` writes the evaluation-noise pickles (numpy
only). The rest measure on the card: the probes of the int8 layer, ports
of the JAX package's `scripts/bench_int8_gemm_rows.py` (the GEMM skeleton at
four row counts) and `scripts/bench_int8_layer.py` (the layer's
ablations), and `ab_train_kernels` (the training layer's bf16 kernels
against another checkout, in turns on one card). Run as modules:
`python -m rohm_tpu_torch.scripts.make_eval_noise`,
`python -m rohm_tpu_torch.scripts.bench_int8_gemm_rows`,
`python -m rohm_tpu_torch.scripts.bench_int8_layer`,
`python -m rohm_tpu_torch.scripts.ab_train_kernels --other DIR`.
"""
