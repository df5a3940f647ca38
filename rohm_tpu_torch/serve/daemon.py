"""The resident-server daemon: accepts CLI requests over a unix socket and
runs them in its own process, so the CUDA context, the kernel library, the
body model and the warm models (test_amass_full's memo) stay resident
between runs. The port of rohm_tpu/serve/daemon.py.

Request dicts: {"op": "run", "cmd": <cli name>, "argv": [...], "cwd": str}
              {"op": "ping"} | {"op": "stop"}
Response:     {"ok": bool, "result": ..., "stdout": str, "error": str|None}

One request at a time. Idle auto-exit frees the card's memory: a forgotten
daemon must never hold it from training jobs. After each request the daemon
releases the CUDA caching allocator's unused blocks, so a
resident daemon holds only its warm models, not the last batch's
activations, and puts back what a CLI changes for the whole process (the
working directory, the TF32 switches, torch's global RNG, loggers' handlers,
a torch.distributed group left open).

Each request's log line gives its seconds, its kernel launches (the
counters of rohm_tpu_torch/ops' wrappers, as JSON) and its peak device
memory: a served run happens in this process, so that line is where another
process sees that the kernels ran.

Liveness protocol: the daemon holds an exclusive flock on `<socket>.owner`
for its whole life. A ping answers only when the daemon is idle
(single-threaded), but the flock is held even mid-request and is released
by the kernel the instant the process dies, so clients (and a second
daemon's displacement guard) tell "busy" from "dead" without racing a ping
timeout into spawning a second daemon on the same card.
"""

from __future__ import annotations

import contextlib
import fcntl
import importlib
import io
import json
import logging
import os
import socket
import subprocess
import sys
import time
import traceback

from rohm_tpu_torch.serve import DEFAULT_SOCKET, IN_SERVER_ENV
from rohm_tpu_torch.serve.protocol import encode, recv_msg, send_bytes, send_msg

# the inference and eval CLIs; the train CLIs are long runs that amortize
# their start-up themselves.
# INVARIANT: every served command must be IDEMPOTENT (safe to run twice with
# the same argv: these all overwrite their outputs). The client retries a
# lost connection once by re-sending the request (client.py run_cli), which
# can re-run a request whose reply was lost; do not add a non-idempotent
# command here without removing that retry.
ALLOWED_CMDS = (
    "test_amass_full", "test_trajnet", "test_posenet", "test_prox_egobody",
    "eval_amass_full", "eval_prox_egobody",
)
# a launcher's variables would make a served --data_parallel run join a
# job that is not there (parallel/mesh.py::launched)
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


class _Tee(io.TextIOBase):
    """Mirror CLI prints to the daemon log while capturing them for the client."""

    def __init__(self, real):
        self.real = real
        self.buf = io.StringIO()

    def write(self, s):
        self.real.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.real.flush()


def _handlers() -> dict:
    loggers = [logging.getLogger()] + [
        lg for lg in logging.Logger.manager.loggerDict.values() if isinstance(lg, logging.Logger)]
    return {lg: list(lg.handlers) for lg in loggers}


@contextlib.contextmanager
def _request_scope():
    """Put back what a CLI changes for the whole process: the working
    directory, the TF32 switches, torch's global RNG (CPU and the card),
    the handlers added to loggers, a torch.distributed group left open; then
    free the caching allocator's unused blocks."""
    import torch
    import torch.distributed as dist

    cwd = os.getcwd()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    handlers = _handlers()
    cuda = torch.cuda.is_initialized()
    try:
        with torch.random.fork_rng(devices=[torch.cuda.current_device()] if cuda else []):
            yield
    finally:
        os.chdir(cwd)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        for lg, now in _handlers().items():
            for h in now:
                if h not in handlers.get(lg, ()):
                    lg.removeHandler(h)
                    h.close()
        if dist.is_available() and dist.is_initialized():
            print("[serve] the request left a torch.distributed group open; destroying it", flush=True)
            dist.destroy_process_group()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _handle_run(req: dict) -> dict:
    cmd = req.get("cmd", "")
    if cmd not in ALLOWED_CMDS:
        return {"ok": False, "result": None, "stdout": "",
                "error": f"unknown cmd {cmd!r}; allowed: {ALLOWED_CMDS}"}
    import torch

    from rohm_tpu_torch.ops import launch_counts

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    before = launch_counts()
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    result, err, ok = None, None, False
    # everything that can fail (chdir to a deleted client cwd, a CLI module
    # that no longer imports, the run itself) must produce a traceback in the
    # response: a raise outside the try would close the socket replyless
    try:
        with _request_scope():
            cwd = req.get("cwd")
            if cwd:
                os.chdir(cwd)
            mod = importlib.import_module(f"rohm_tpu_torch.cli.{cmd}")
            with contextlib.redirect_stdout(tee):
                result = mod.main(req.get("argv", []))
        ok = True
    except KeyboardInterrupt:
        raise  # a foreground daemon must stay Ctrl-C-able mid-request
    except BaseException:  # noqa: BLE001 - survive any CLI failure, argparse's SystemExit too
        err = traceback.format_exc()
    launches = {k: v - before.get(k, 0) for k, v in launch_counts().items() if v != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    print(f"[serve] {cmd} finished in {time.perf_counter() - t0:.3f}s ok={ok} "
          f"launches={json.dumps(launches)} peak_bytes={peak}", flush=True)
    return {"ok": ok, "result": result, "stdout": tee.buf.getvalue(), "error": err}


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _warm_device(device: str) -> None:
    """On the card: the CUDA context and the kernel library (built with nvcc
    if absent), so the first client pays for neither. With no CUDA device
    this raises: the daemon never serves on the CPU in the card's place."""
    import torch

    if device == "cpu":
        print("[serve] device=cpu", flush=True)
        return
    if device != "cuda":
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the server runs on the card; "
                           "pass --device=cpu to serve on the CPU")
    torch.cuda.init()
    from rohm_tpu_torch.ops import _build

    _build.library()
    print(f"[serve] device={torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"power_limit={_power_limit()}", flush=True)


def serve(socket_path: str = DEFAULT_SOCKET, idle_timeout: float = 600.0,
          conn_recv_timeout: float = 60.0, device: str = "cuda") -> None:
    """Run the daemon until `stop` or idle_timeout seconds without requests,
    on the card unless `device` is "cpu"."""
    # a CLI running INSIDE the daemon must never relay back out, even if its
    # YAML sets via_server: true (maybe_via_server checks this guard);
    # without it a config-set flag would recurse into spawning daemons
    os.environ[IN_SERVER_ENV] = "1"
    for var in LAUNCHER_VARS:
        os.environ.pop(var, None)

    # Ownership gate, BEFORE any CUDA work: refuse to displace a live daemon
    # (unlinking its socket would orphan a process holding the card's
    # memory). The flock is held even while the incumbent is busy, unlike a
    # ping, and dies with its process.
    owner_fd = os.open(socket_path + ".owner", os.O_CREAT | os.O_RDWR, 0o600)
    # Retry briefly: clients' liveness probes take a momentary LOCK_SH on
    # this file (client.daemon_process_exists); a real incumbent holds
    # LOCK_EX for its whole life, so only a lock still held after ~2 s is
    # a genuine owner.
    for _ in range(40):
        try:
            fcntl.flock(owner_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            break
        except OSError:
            time.sleep(0.05)
    else:
        os.close(owner_fd)
        print(f"[serve] a live daemon (possibly mid-request) owns "
              f"{socket_path}; exiting", flush=True)
        return
    os.ftruncate(owner_fd, 0)
    os.write(owner_fd, str(os.getpid()).encode())
    try:
        _warm_device(device)
        _serve_locked(socket_path, idle_timeout, conn_recv_timeout)
    finally:
        os.close(owner_fd)  # releases the flock; the .owner file stays
        # (unlinking it would race a waiter that just opened the same inode)


def _serve_locked(socket_path: str, idle_timeout: float,
                  conn_recv_timeout: float) -> None:
    if os.path.exists(socket_path):
        os.unlink(socket_path)  # dead leftover (we hold the owner flock)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    os.chmod(socket_path, 0o700)
    srv.listen(4)
    srv.settimeout(5.0)
    print(f"[serve] listening on {socket_path} (idle_timeout={idle_timeout:.0f}s)",
          flush=True)
    last_req = time.monotonic()
    try:
        while True:
            if time.monotonic() - last_req > idle_timeout:
                # Final drain before exiting: a client that saw the socket
                # connectable just before the deadline may already sit in
                # the listener backlog; closing now would EOF its reply.
                # If anything is queued, serve it (which resets last_req);
                # only an empty backlog ends the daemon.
                try:
                    srv.settimeout(0.0)
                    conn, _ = srv.accept()
                except BlockingIOError:  # the expected empty-backlog signal
                    print("[serve] idle timeout: releasing the device", flush=True)
                    return
                except OSError as e:  # a real accept() failure, not idleness
                    print(f"[serve] accept failed at idle deadline ({e!r}); "
                          "exiting", flush=True)
                    return
                finally:
                    srv.settimeout(5.0)
            else:
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
            with conn:
                # accepted sockets block regardless of the listener's
                # timeout; a silent client must not wedge the daemon (and its
                # idle exit) forever. The default 60 s covers any honest
                # request: clients send right after connecting.
                conn.settimeout(conn_recv_timeout)
                try:
                    req = recv_msg(conn)
                except Exception:
                    continue
                last_req = time.monotonic()
                op = req.get("op")
                try:
                    if op == "ping":
                        send_msg(conn, {"ok": True, "pid": os.getpid()})
                    elif op == "stop":
                        send_msg(conn, {"ok": True})
                        print("[serve] stop requested", flush=True)
                        return
                    elif op == "run":
                        resp = _handle_run(req)
                        try:
                            payload = encode(resp)
                        except Exception:
                            # an unpicklable CLI return value must become an
                            # error reply, not a swallowed exception that
                            # leaves the client waiting for its timeout
                            payload = encode({
                                "ok": False, "result": None,
                                "stdout": resp.get("stdout", ""),
                                "error": "CLI result not picklable:\n"
                                         + traceback.format_exc(),
                            })
                        send_bytes(conn, payload)
                        last_req = time.monotonic()
                    else:
                        send_msg(conn, {"ok": False, "error": f"bad op {op!r}"})
                except Exception:
                    # the client hung up (Ctrl-C, its own timeout) while we
                    # ran or sent: the daemon and its warm state must
                    # survive; the run's outputs are already on disk
                    print("[serve] client connection lost mid-reply "
                          f"({traceback.format_exc(limit=1).splitlines()[-1]})",
                          flush=True)
                    continue
    finally:
        srv.close()
        with contextlib.suppress(OSError):
            # we hold the owner flock until process/fd teardown, so no other
            # daemon can have rebound the name: the socket path is ours
            os.unlink(socket_path)
