"""Measurement probes of the int8 layer on the card, the ports of the JAX
package's `scripts/bench_int8_gemm_rows.py` (the GEMM skeleton at four row
counts) and `scripts/bench_int8_layer.py` (the layer's ablations). Run as
modules: `python -m rohm_tpu_torch.scripts.bench_int8_gemm_rows`,
`python -m rohm_tpu_torch.scripts.bench_int8_layer`.
"""
