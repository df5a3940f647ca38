"""The share of the traced PROX batch in which no operation ran on the card:
device_idle.recon's reading."""

from harness.spec import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "device_idle.recon.py").read
