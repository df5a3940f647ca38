"""Client side of the resident server: the port of rohm_tpu/serve/client.py.

Standard library only: it imports neither torch nor any CLI module, so a
client that only relays a request starts in well under a second (and runs
under `python -S`, without site-packages).
"""

from __future__ import annotations

import fcntl
import os
import socket
import subprocess
import sys
import time


def _connect(socket_path: str, timeout: float = 5.0) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect(socket_path)
    return sock


def _request(msg: dict, socket_path: str, timeout: float):
    from rohm_tpu_torch.serve.protocol import recv_msg, send_msg

    with _connect(socket_path, timeout) as sock:
        send_msg(sock, msg)
        sock.settimeout(timeout)
        return recv_msg(sock)


def _default(socket_path: str | None) -> str:
    from rohm_tpu_torch.serve import DEFAULT_SOCKET

    return socket_path or DEFAULT_SOCKET


def server_alive(socket_path: str | None = None) -> bool:
    """True iff a daemon answers a ping, i.e. it is alive AND idle. A daemon
    mid-request cannot answer (it is single-threaded); see
    daemon_process_exists for busy versus dead."""
    socket_path = _default(socket_path)
    if not os.path.exists(socket_path):
        return False
    try:
        return bool(_request({"op": "ping"}, socket_path, 5.0).get("ok"))
    except OSError:
        return False


def daemon_process_exists(socket_path: str | None = None) -> bool:
    """True iff a daemon PROCESS holds the owner flock, even one busy inside
    a long request that cannot answer pings. The kernel releases the flock
    the instant its holder dies, so this never reports a stale owner."""
    socket_path = _default(socket_path)
    try:
        fd = os.open(socket_path + ".owner", os.O_CREAT | os.O_RDWR, 0o600)
    except OSError:
        return False
    try:
        # LOCK_SH, not LOCK_EX: a read-only probe must never look like an
        # owner to a booting daemon's LOCK_EX gate (or to another client
        # probing at the same time); shared locks coexist with each other
        # but fail against the daemon's exclusive one
        fcntl.flock(fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
        fcntl.flock(fd, fcntl.LOCK_UN)
        return False
    except OSError:
        return True
    finally:
        os.close(fd)


def _socket_connectable(socket_path: str) -> bool:
    """A bound listener accepts connects (into its backlog) even while the
    daemon is busy; a booting daemon has not bound yet and a dead one's
    stale path refuses."""
    try:
        _connect(socket_path, 2.0).close()
        return True
    except OSError:
        return False


def stop_server(socket_path: str | None = None) -> bool:
    socket_path = _default(socket_path)
    if not os.path.exists(socket_path):
        return False
    try:
        return bool(_request({"op": "stop"}, socket_path, 10.0).get("ok"))
    except OSError:
        return False


def ensure_server(
    socket_path: str | None = None, start_timeout: float = 300.0,
    idle_timeout: float = 600.0, log_path: str | None = None,
    device: str = "cuda",
) -> None:
    """Make sure a daemon is reachable: return if one answers a ping OR is
    alive but busy (its backlog will queue our request); otherwise spawn a
    detached one (`device` "cuda", or "cpu") and wait until it answers (the
    spawn pays torch's import, the CUDA context and the kernel library).

    Spawns are serialized by an flock on `<socket>.spawn_lock`, held for the
    boot wait and released by the kernel if the spawning client dies, so
    there is no staleness heuristic to race on. A busy live daemon is told
    apart by the `.owner` flock it holds for its whole life; without that, a
    ping timeout against a daemon mid-request would spawn a second daemon
    beside it on the same card. At most 3 spawns per call.
    """
    from rohm_tpu_torch.serve import DEFAULT_LOG

    socket_path = _default(socket_path)
    log_path = log_path or DEFAULT_LOG
    if server_alive(socket_path):
        return
    lock_fd = os.open(socket_path + ".spawn_lock", os.O_CREAT | os.O_RDWR, 0o600)
    got_lock = False
    proc = None
    spawns = 0
    try:
        deadline = time.monotonic() + start_timeout
        while True:
            if daemon_process_exists(socket_path):
                if _socket_connectable(socket_path):
                    # alive: idle (it would answer a ping) or mid-request (our
                    # request queues in the listener backlog)
                    return
                # else a daemon is booting (flock held, socket not bound yet)
            elif not got_lock:
                try:
                    fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    got_lock = True
                except OSError:
                    pass  # another client is spawning; wait for its daemon
            if got_lock and not daemon_process_exists(socket_path) and (
                proc is None or proc.poll() is not None
            ):
                if spawns >= 3:
                    raise RuntimeError(
                        f"spawned rohm_tpu_torch server exited {spawns}x without "
                        f"binding {socket_path} (see {log_path})"
                    )
                with open(log_path, "ab") as log:
                    proc = subprocess.Popen(
                        [sys.executable, "-m", "rohm_tpu_torch.serve", "serve",
                         f"--socket={socket_path}", f"--idle_timeout={idle_timeout}",
                         f"--device={device}"],
                        stdout=log, stderr=log, start_new_session=True,
                        cwd=os.getcwd(),
                    )
                spawns += 1
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"rohm_tpu_torch server did not come up within "
                    f"{start_timeout:.0f}s (see {log_path})"
                )
            time.sleep(1.0)
    finally:
        os.close(lock_fd)  # releases the spawn flock if we held it


def run_cli(cmd: str, argv: list[str], socket_path: str | None = None,
            auto_start: bool = True, timeout: float = 3600.0):
    """Run `rohm_tpu_torch.cli.<cmd>.main(argv)` on the resident server;
    print its stdout here and return its return value. Raises RuntimeError
    with the server-side traceback on failure. A daemon started here runs
    on the CPU when argv asks for --device=cpu, else on the card."""
    socket_path = _default(socket_path)
    msg = {"op": "run", "cmd": cmd, "argv": list(argv), "cwd": os.getcwd()}
    device = _daemon_device(argv)
    if auto_start:
        ensure_server(socket_path, device=device)
    try:
        resp = _request(msg, socket_path, timeout)
    except (ConnectionError, FileNotFoundError) as e:
        # The daemon can idle-exit (or die) between our liveness check and
        # the reply: the connect refuses, or recv_msg hits EOF on the
        # drained backlog. One respawn and retry is safe: the served CLIs
        # are idempotent (they overwrite their outputs), and a request the
        # daemon never accepted never ran.
        if not auto_start:
            raise
        print(f"[serve-client] connection lost ({e}); restarting the server "
              "and retrying once", flush=True)
        ensure_server(socket_path, device=device)
        resp = _request(msg, socket_path, timeout)
    if resp.get("stdout"):
        sys.stdout.write(resp["stdout"])
        sys.stdout.flush()
    if not resp.get("ok"):
        raise RuntimeError(f"server-side {cmd} failed:\n{resp.get('error')}")
    return resp.get("result")


def _daemon_device(argv: list[str]) -> str:
    """"cpu" if argv holds --device=cpu (or `--device cpu`), else "cuda"."""
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            a = "--device=" + argv[i + 1]
        if a.lower() == "--device=cpu":
            return "cpu"
    return "cuda"


def _argv_via_server(argv: list[str]) -> tuple[bool, list[str]]:
    """Scan argv for a truthy --via_server; returns (found, argv without
    the flag). Self-contained so the relay never imports the CLI or torch.
    The truthy set must match utils/config.str2bool (the CLI's parser), or
    one flag value would relay here but run locally in the CLI."""
    truthy = ("true", "1")
    out: list[str] = []
    found = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--via_server":
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                found = found or argv[i + 1].lower() in truthy
                i += 2
            else:
                found = True
                i += 1
            continue
        if a.startswith("--via_server="):
            found = found or a.split("=", 1)[1].lower() in truthy
            i += 1
            continue
        out.append(a)
        i += 1
    return found, out


def maybe_relay_light(cmd: str, argv: list[str] | None = None) -> bool:
    """Fast path for an entry script: if argv carries a truthy --via_server,
    relay the run to the resident server WITHOUT importing torch or the CLI
    module. A via_server set only in the YAML is not seen here; the CLI's own
    `maybe_via_server` (cli/common.py) relays that case. Returns True when
    the run was relayed (the caller then skips its main())."""
    from rohm_tpu_torch.serve import IN_SERVER_ENV

    if os.environ.get(IN_SERVER_ENV):
        return False
    argv = list(sys.argv[1:] if argv is None else argv)
    found, fwd = _argv_via_server(argv)
    if not found:
        return False
    run_cli(cmd, fwd)
    return True
