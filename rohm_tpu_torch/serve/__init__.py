"""Resident inference server: one warm process that keeps the CUDA context,
the loaded kernel library, the body model and the initialized models (with
their kernels' prepared weights) between CLI runs, so a repeat run skips
the start-up every fresh process pays. The port of rohm_tpu/serve/.

  python -m rohm_tpu_torch.serve            # run the daemon in the foreground
  python -m rohm_tpu_torch.cli.test_amass_full --via_server=True ...   # route through it
  python -m rohm_tpu_torch.serve stop       # shut it down

Clients start the daemon when none is running (the first run pays the
warm-up), and the daemon exits after --idle_timeout seconds without
requests, freeing the card's memory for other processes.

Its names differ from the JAX package's (socket, environment variables, log),
so the two daemons can live on one host and never answer each other's
clients. This package imports only the standard library; the daemon imports
torch when it starts serving.
"""

import os

DEFAULT_SOCKET = os.environ.get("ROHM_TORCH_SERVER_SOCKET", "/tmp/rohm_tpu_torch_server.sock")
DEFAULT_LOG = "/tmp/rohm_tpu_torch_server.log"
# set inside the daemon: a CLI running there never relays back out
IN_SERVER_ENV = "ROHM_TPU_TORCH_IN_SERVER"

from rohm_tpu_torch.serve.client import run_cli, server_alive, stop_server  # noqa: E402,F401
