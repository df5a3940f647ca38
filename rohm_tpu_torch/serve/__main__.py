"""python -m rohm_tpu_torch.serve [serve|stop|ping] [--socket=...] [--idle_timeout=...] [--device=cuda|cpu]"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("rohm_tpu_torch resident server")
    p.add_argument("action", nargs="?", default="serve",
                   choices=["serve", "stop", "ping"])
    p.add_argument("--socket", type=str, default=None)
    p.add_argument("--idle_timeout", type=float, default=600.0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="serve on the card (the default; no CUDA device is an error) or on the CPU")
    args = p.parse_args(argv)

    if args.action == "stop":
        from rohm_tpu_torch.serve.client import stop_server

        ok = stop_server(args.socket)
        print("stopped" if ok else "no server running")
        return 0
    if args.action == "ping":
        from rohm_tpu_torch.serve.client import server_alive

        alive = server_alive(args.socket)
        print("alive" if alive else "no server")
        return 0 if alive else 1

    from rohm_tpu_torch.serve import DEFAULT_SOCKET
    from rohm_tpu_torch.serve.daemon import serve

    serve(args.socket or DEFAULT_SOCKET, idle_timeout=args.idle_timeout, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
