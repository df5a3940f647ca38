"""The whole batch's share of the card's peak, in %, in the PROX cell:
mfu.recon's reading, whose least time the PROX driver counts at the 980
steps an early-stopped chain runs."""

from harness.spec import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "mfu.recon.py").read
