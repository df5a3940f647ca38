"""The port's resident server (rohm_tpu_torch/serve) on the CPU, case by case
after tests/test_serve.py: protocol framing, flag scanning, the daemon's
ping/stop/unknown-command paths, its survival of failing CLIs and of clients
that hang up or stay silent, the owner flock and the spawn lock. Then the
port's own cases: names apart from the JAX daemon's, no CPU fallback for a
card daemon, two served tiny `test_amass_full --device=cpu` runs (the second
a warm hit) byte for byte the direct run and within tests/test_torch_cli_amass.py's
tolerance of the JAX CLI on the same checkpoints and replayed noise, and two
served `--data_parallel=True` runs (a gloo group of one each).

Each daemon runs `serve(..., device="cpu")` in a thread of this process.
serve() sets its in-server variable process-wide (it assumes a process of
its own), so the fixtures restore it, and never touch the JAX package's.
"""

import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from rohm_tpu_torch.serve import IN_SERVER_ENV
from rohm_tpu_torch.serve import client as sclient
from rohm_tpu_torch.serve.protocol import recv_msg, send_msg
from rohm_tpu_torch.utils.config import strip_flag

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "cfg_files" / "test_cfg" / "amass_occ_leg_noise_3.yaml")
CLIP_LEN, STEPS_TRAJ, STEPS_POSE, ITERS = 17, 3, 4, 1


def test_strip_flag_forms():
    argv = ["--a=1", "--via_server=True", "--b", "2"]
    assert strip_flag(argv, "--via_server") == ["--a=1", "--b", "2"]
    argv = ["--via_server", "True", "--a=1"]
    assert strip_flag(argv, "--via_server") == ["--a=1"]
    argv = ["--via_server", "--a=1"]
    assert strip_flag(argv, "--via_server") == ["--a=1"]
    # names that merely share the prefix are untouched
    argv = ["--via_server_x=1"]
    assert strip_flag(argv, "--via_server") == ["--via_server_x=1"]


def test_protocol_roundtrip_large():
    a, b = socket.socketpair()
    payload = {"arr": np.arange(300_000, dtype=np.float32), "s": "x" * 10_000}
    t = threading.Thread(target=lambda: send_msg(a, payload))
    t.start()
    got = recv_msg(b)
    t.join()
    np.testing.assert_array_equal(got["arr"], payload["arr"])
    assert got["s"] == payload["s"]
    a.close()
    b.close()


@pytest.fixture
def in_server_env():
    """Restore the port's in-server variable after a test's daemons."""
    prior = os.environ.get(IN_SERVER_ENV)
    yield
    if prior is None:
        os.environ.pop(IN_SERVER_ENV, None)
    else:
        os.environ[IN_SERVER_ENV] = prior


def _start_daemon(sock_path: str, **kwargs):
    """serve() on the CPU on a tmp socket in a thread; returns the thread once alive."""
    from rohm_tpu_torch.serve import daemon as sdaemon

    kwargs.setdefault("idle_timeout", 300.0)
    kwargs.setdefault("device", "cpu")
    t = threading.Thread(target=sdaemon.serve, args=(sock_path,), kwargs=kwargs, daemon=True)
    t.start()
    for _ in range(500):
        if sclient.server_alive(sock_path):
            return t
        time.sleep(0.1)
    raise TimeoutError("daemon did not come up")


@pytest.fixture
def daemon(tmp_path, in_server_env):
    """A live daemon on a tmp socket; stopped through the client on teardown."""
    sock_path = str(tmp_path / "srv.sock")
    t = _start_daemon(sock_path)
    yield sock_path
    sclient.stop_server(sock_path)
    t.join(timeout=10)


def test_ping_unknown_cmd_and_stop(daemon):
    assert sclient.server_alive(daemon)
    with pytest.raises(RuntimeError, match="unknown cmd"):
        sclient.run_cli("rm_rf", [], socket_path=daemon, auto_start=False)
    # a failing CLI returns the server-side traceback, the daemon survives
    with pytest.raises(RuntimeError, match="Traceback"):
        sclient.run_cli("eval_amass_full", ["--saved_data_path=/nonexistent.pkl"],
                        socket_path=daemon, auto_start=False)
    assert sclient.server_alive(daemon)
    assert sclient.stop_server(daemon)
    for _ in range(100):
        if not sclient.daemon_process_exists(daemon):
            break
        time.sleep(0.1)
    assert not sclient.server_alive(daemon) and not sclient.daemon_process_exists(daemon)


def test_argv_via_server_forms():
    f = sclient._argv_via_server
    assert f(["--a=1", "--via_server=True", "--b", "2"]) == (True, ["--a=1", "--b", "2"])
    assert f(["--via_server", "True", "--a=1"]) == (True, ["--a=1"])
    assert f(["--via_server", "--a=1"]) == (True, ["--a=1"])
    assert f(["--via_server=False", "--a=1"]) == (False, ["--a=1"])
    assert f(["--a=1"]) == (False, ["--a=1"])


def test_argv_via_server_truthy_matches_str2bool():
    """The light relay and the CLI's parser agree on which values are truthy."""
    from rohm_tpu_torch.utils.config import str2bool

    f = sclient._argv_via_server
    for val in ("true", "True", "1", "yes", "YES", "false", "0", "no", "on"):
        assert f([f"--via_server={val}"])[0] == str2bool(val), val


def test_daemon_device_from_argv():
    """A daemon the client starts runs where the request asks: the CPU for
    --device=cpu, else the card."""
    f = sclient._daemon_device
    assert f(["--device=cpu", "--a=1"]) == f(["--device", "CPU"]) == "cpu"
    assert f(["--device=0"]) == f([]) == f(["--device"]) == "cuda"


def test_maybe_relay_light_noops_inside_server(monkeypatch):
    """The environment guard stops re-relaying inside the daemon."""
    monkeypatch.setenv(IN_SERVER_ENV, "1")
    assert sclient.maybe_relay_light("test_amass_full", ["--via_server=True"]) is False


def test_maybe_via_server_noops_inside_server(monkeypatch):
    """The CLI's own relay, for a via_server set in the YAML, obeys the same guard."""
    from rohm_tpu_torch.cli.common import maybe_via_server

    args = SimpleNamespace(via_server=True)
    monkeypatch.setenv(IN_SERVER_ENV, "1")
    assert maybe_via_server("test_amass_full", args, ["--via_server=True"]) == (False, None)
    monkeypatch.delenv(IN_SERVER_ENV)
    assert maybe_via_server("test_amass_full", SimpleNamespace(via_server=False), []) == (False, None)


def test_daemon_survives_client_disconnect(daemon):
    """A client that hangs up before the reply must not end the daemon."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(daemon)
    send_msg(sock, {"op": "ping"})
    sock.close()
    time.sleep(0.2)
    assert sclient.server_alive(daemon)


def test_daemon_unwedges_from_silent_client(tmp_path, in_server_env):
    """A client that connects but never sends must not wedge the accept
    loop: its socket's receive timeout (1 s here) expires and a ping sent
    meanwhile is answered."""
    sock_path = str(tmp_path / "srv.sock")
    t = _start_daemon(sock_path, conn_recv_timeout=1.0)
    try:
        silent = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        silent.connect(sock_path)  # never sends
        try:
            t0 = time.monotonic()
            assert sclient.server_alive(sock_path)
            assert time.monotonic() - t0 < 10.0
        finally:
            silent.close()
    finally:
        sclient.stop_server(sock_path)
        t.join(timeout=10)


def test_daemon_process_exists_tracks_owner_flock(daemon, tmp_path):
    assert sclient.daemon_process_exists(daemon)
    assert not sclient.daemon_process_exists(str(tmp_path / "other.sock"))


def test_second_daemon_refuses_to_displace(daemon, capsys):
    """serve() on an owned socket returns at once (the incumbent holds the
    owner flock) instead of taking the device and the socket."""
    from rohm_tpu_torch.serve import daemon as sdaemon

    sdaemon.serve(daemon, idle_timeout=5.0, device="cpu")
    assert "live daemon" in capsys.readouterr().out
    assert sclient.server_alive(daemon)


def test_run_failure_paths_return_tracebacks(daemon, tmp_path):
    """A chdir into a client cwd that is gone produces an error reply with
    the traceback, not a closed socket, and the daemon's own cwd stays."""
    gone = tmp_path / "gone"
    gone.mkdir()
    gone.rmdir()
    cwd = os.getcwd()
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(30.0)
        sock.connect(daemon)
        send_msg(sock, {"op": "run", "cmd": "eval_amass_full", "argv": [], "cwd": str(gone)})
        resp = recv_msg(sock)
    assert resp["ok"] is False and "FileNotFoundError" in resp["error"]
    assert os.getcwd() == cwd


def test_ensure_server_waits_on_foreign_spawn_lock(tmp_path, monkeypatch):
    """While another client holds the spawn flock (it is booting a daemon),
    ensure_server waits and spawns nothing; once the lock is free, the next
    client spawns exactly once, then waits."""
    import fcntl

    sock_path = str(tmp_path / "none.sock")
    spawned = []
    monkeypatch.setattr(sclient.subprocess, "Popen", lambda *a, **k: spawned.append(a) or None)
    fd = os.open(sock_path + ".spawn_lock", os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX)
    try:
        with pytest.raises(TimeoutError):
            sclient.ensure_server(sock_path, start_timeout=1.5, log_path=str(tmp_path / "log"))
        assert spawned == []
    finally:
        os.close(fd)

    class _FakeProc:
        def poll(self):
            return None  # still booting

    monkeypatch.setattr(sclient.subprocess, "Popen", lambda *a, **k: spawned.append(a) or _FakeProc())
    with pytest.raises(TimeoutError):
        sclient.ensure_server(sock_path, start_timeout=1.5, log_path=str(tmp_path / "log"), device="cpu")
    assert len(spawned) == 1
    cmd = spawned[0][0]
    assert cmd[1:4] == ["-m", "rohm_tpu_torch.serve", "serve"] and "--device=cpu" in cmd


def test_ensure_server_returns_for_busy_daemon(tmp_path, monkeypatch):
    """A daemon that holds the owner flock but cannot answer pings (it is
    mid-request) is not displaced: the request queues in its backlog."""
    import fcntl

    sock_path = str(tmp_path / "busy.sock")
    spawned = []
    monkeypatch.setattr(sclient.subprocess, "Popen", lambda *a, **k: spawned.append(a) or None)
    fd = os.open(sock_path + ".owner", os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(4)
    try:
        sclient.ensure_server(sock_path, start_timeout=5.0)  # returns, no raise
        assert spawned == []
    finally:
        srv.close()
        os.close(fd)


def test_relay_import_is_sitefree():
    """`python -S` (no site-packages, so no torch) imports the client and the
    protocol: the relay needs the standard library alone."""
    proc = subprocess.run(
        [sys.executable, "-S", "-c",
         "import sys; sys.path.insert(0, '.');"
         "from rohm_tpu_torch.serve.client import maybe_relay_light, run_cli;"
         "import rohm_tpu_torch.serve.protocol;"
         "print('SITEFREE-OK', 'site' in sys.modules, 'torch' in sys.modules)"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=60,
    )
    assert proc.returncode == 0, proc.stderr
    assert "SITEFREE-OK False False" in proc.stdout, proc.stdout


def test_ensure_server_real_spawn_roundtrip(tmp_path):
    """The unmocked boot path: ensure_server starts `python -m
    rohm_tpu_torch.serve serve --device=cpu`, which takes the owner flock,
    binds, answers a ping and logs its device; stop ends the process (its
    flock is released)."""
    sock_path = str(tmp_path / "s.sock")  # a unix socket's path holds at most 107 bytes
    log_path = tmp_path / "server.log"
    sclient.ensure_server(sock_path, start_timeout=120.0, idle_timeout=60.0, log_path=str(log_path),
                          device="cpu")
    try:
        assert sclient.server_alive(sock_path)
        assert sclient.daemon_process_exists(sock_path)
    finally:
        assert sclient.stop_server(sock_path)
    for _ in range(100):
        if not sclient.daemon_process_exists(sock_path):
            break
        time.sleep(0.1)
    else:
        raise AssertionError("daemon still holds the owner flock after stop")
    assert "[serve] device=cpu" in log_path.read_text()


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


def test_names_apart_from_the_jax_daemon():
    """Socket, log, environment variables: none shared with rohm_tpu/serve,
    so neither package's client reaches the other's daemon."""
    import rohm_tpu.serve as jserve
    import rohm_tpu_torch.serve as tserve

    assert tserve.DEFAULT_SOCKET != jserve.DEFAULT_SOCKET
    assert tserve.DEFAULT_SOCKET == os.environ.get("ROHM_TORCH_SERVER_SOCKET", "/tmp/rohm_tpu_torch_server.sock")
    assert tserve.DEFAULT_LOG == "/tmp/rohm_tpu_torch_server.log" != "/tmp/rohm_tpu_server.log"
    assert IN_SERVER_ENV == "ROHM_TPU_TORCH_IN_SERVER" != "ROHM_TPU_IN_SERVER"


def test_card_daemon_never_serves_on_the_cpu(tmp_path, in_server_env):
    """serve() on the card with no CUDA device raises after its ownership
    gate and releases the owner flock; it never binds the socket."""
    import torch

    from rohm_tpu_torch.serve import daemon as sdaemon

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")  # the refusal needs a host without one
    sock_path = str(tmp_path / "card.sock")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdaemon.serve(sock_path, device="cuda")
    assert not os.path.exists(sock_path) and not sclient.daemon_process_exists(sock_path)


def _preset_noise(b: int, t_traj: int, tf: int) -> dict:
    rng = np.random.default_rng(11)
    shapes = {
        "traj_init": (ITERS, b, t_traj, tf),
        "traj_step": (ITERS, STEPS_TRAJ, b, t_traj, tf),
        "pose_init": (ITERS, b, t_traj - 1, 294),
        "pose_step": (ITERS, STEPS_POSE, b, t_traj - 1, 294),
    }
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _with_noise(run_batch):
    def wrapped(self, traj_cond, *args, **kwargs):
        kwargs["preset_noise"] = _preset_noise(*np.shape(traj_cond))
        return run_batch(self, traj_cond, *args, **kwargs)
    return wrapped


def _checkpoints(ckpt_dir: Path) -> tuple[dict, dict]:
    """JAX-initialised TrajNet, TrajControl and PoseNet params (zero leaves
    woken) as flattened-flax .npz, as tests/test_torch_cli_amass.py makes
    them. Returns (paths, the init params by model kind)."""
    import flax
    import jax

    from rohm_tpu.cli import common as jcommon

    args = SimpleNamespace(mid_dim=64, latent_dim=32)
    rng = np.random.default_rng(0)
    control = jax.tree.map(np.asarray, jcommon.init_trajnet_params(
        jcommon.build_trajnet(args, 13, True), CLIP_LEN, 0))
    made = {
        "trajnet": {"params": {k: v for k, v in control["params"].items() if k != "ControlNet_0"}},
        "trajcontrol": control,
        "posenet": jax.tree.map(np.asarray, jcommon.init_posenet_params(
            jcommon.build_posenet(args), CLIP_LEN, 0)),
    }
    paths = {}
    for name, params in made.items():
        flat = flax.traverse_util.flatten_dict(params, sep="/")
        flat = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32) if not v.any() else v
                for k, v in flat.items()}
        os.makedirs(ckpt_dir / name, exist_ok=True)
        paths[name] = str(ckpt_dir / name / f"{name}.npz")
        np.savez(paths[name], **flat)
    return paths, made


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX CLI, a direct run of the port's CLI, two served runs and two
    served --data_parallel=True runs, all on one tree, one set of
    checkpoints and one replayed noise. Returns each run's pickle path and
    what each served run printed (the daemon thread prints into the same
    sys.stdout, so its per-request line is there too)."""
    import contextlib
    import io

    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu.cli import test_amass_full as jcli
    from rohm_tpu.data import write_synthetic_amass as jax_write_amass
    from rohm_tpu.pipeline import RohmPipeline as JaxPipeline
    from rohm_tpu_torch.cli import test_amass_full as tcli
    from rohm_tpu_torch.pipeline import RohmPipeline

    tmp = tmp_path_factory.mktemp("served")
    ckpt, inits = _checkpoints(tmp / "ckpt")
    jax_write_amass(str(tmp / "amass"), jax_synthetic_model(),
                    datasets={n: 1 for n in ("TCDHands", "TotalCapture", "SFU")}, seq_len=CLIP_LEN + 4)
    argv = [
        f"--config={CONFIG}", "--synthetic_data=True", f"--dataset_root={tmp / 'amass'}",
        f"--clip_len={CLIP_LEN}", "--batch_size=4", "--max_batches=1",
        f"--diffusion_steps_trajnet={STEPS_TRAJ}", f"--diffusion_steps_posenet={STEPS_POSE}",
        "--mid_dim=64", "--latent_dim=32", "--load_noise=False", "--mask_scheme=full",
        f"--sample_iter={ITERS}", "--seed=0",
        f"--model_path_trajnet={ckpt['trajnet']}", f"--model_path_trajnet_control={ckpt['trajcontrol']}",
        f"--model_path_posenet={ckpt['posenet']}",
    ]
    paths, printed = {}, {}
    prior = os.environ.get(IN_SERVER_ENV)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(jcli, "init_trajnet_params", lambda model, clip_len, seed=0: inits[
            "trajcontrol" if model.trajcontrol else "trajnet"])
        mp.setattr(jcli, "init_posenet_params", lambda model, clip_len, seed=0: inits["posenet"])
        mp.setattr(JaxPipeline, "run_batch", _with_noise(JaxPipeline.run_batch))
        mp.setattr(RohmPipeline, "run_batch", _with_noise(RohmPipeline.run_batch))
        paths["jax"] = jcli.main(argv + [f"--save_root={tmp / 'res_jax'}"])
        torch_argv = argv + ["--device=cpu"]
        tcli._WARM.clear()
        paths["direct"] = tcli.main(torch_argv + [f"--save_root={tmp / 'res_direct'}"])
        tcli._WARM.clear()  # the served runs start cold

        import rohm_tpu_torch.serve as tserve

        sock_path = str(tmp / "srv.sock")
        mp.setattr(tserve, "DEFAULT_SOCKET", sock_path)  # where --via_server relays
        t = _start_daemon(sock_path)
        # serve() marked this whole process as the server; the client side
        # (this thread) must relay, and the daemon's CLIs get argv without
        # the flag, so nothing relays twice
        os.environ.pop(IN_SERVER_ENV)
        try:
            for run, extra in (("cold", []), ("warm", []), ("dp1", ["--data_parallel=True"]),
                               ("dp2", ["--data_parallel=True"])):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    paths[run] = tcli.main(
                        ["--via_server=True"] + torch_argv + extra + [f"--save_root={tmp / ('res_' + run)}"])
                printed[run] = buf.getvalue()
        finally:
            sclient.stop_server(sock_path)
            t.join(timeout=10)
            if prior is None:
                os.environ.pop(IN_SERVER_ENV, None)
            else:
                os.environ[IN_SERVER_ENV] = prior
    return paths, printed


def _load(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def test_served_runs_warm_hit_and_bytes(served):
    """The first served run builds the models, the second reuses them (the
    memo's warm hit); both pickles are byte-identical to each other and to
    the direct run in this process."""
    paths, printed = served
    assert "warm hit" not in printed["cold"]
    assert "[test_amass_full] warm hit: reusing resident models + pipeline" in printed["warm"]
    assert "results saved to" in printed["cold"]  # the server's prints reach the client
    for run in ("cold", "warm"):  # the daemon's line: no kernel launches on the CPU
        assert "[serve] test_amass_full finished in" in printed[run]
        assert "ok=True launches={} peak_bytes=None" in printed[run]
    direct = Path(paths["direct"]).read_bytes()
    for run in ("cold", "warm"):
        assert Path(paths[run]).name == Path(paths["direct"]).name
        assert Path(paths[run]).read_bytes() == direct, run


def test_served_run_matches_jax(served):
    """The served run's pickle against the JAX CLI's, key for key, at the
    tolerances tests/test_torch_cli_amass.py states for the direct run
    (1e-5 on the inputs, 1e-3 on the reconstruction)."""
    paths, _ = served
    jdata, tdata = _load(paths["jax"]), _load(paths["warm"])
    assert set(tdata) == set(jdata)
    for key in sorted(set(jdata) - {"mask_scheme", "repr_name_list", "repr_dim_dict"}):
        a, b = tdata[key], jdata[key]
        assert a.shape == b.shape and a.dtype == b.dtype and np.isfinite(a).all(), key
        tol = 1e-3 if "_rec_" in key or key.startswith("motion_repr_rec") else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=key)


def test_served_data_parallel_runs(served):
    """Two served --data_parallel=True runs in a row, each a gloo group of
    one that the CLI makes and destroys: each pickle equals the direct run's,
    array for array, and neither the memo nor the group outlives a request."""
    import torch.distributed as dist

    from rohm_tpu_torch.parallel.mesh import launched

    paths, printed = served
    direct = _load(paths["direct"])
    for run in ("dp1", "dp2"):
        got = _load(paths[run])
        assert sorted(got) == sorted(direct)
        for k, v in direct.items():
            assert np.array_equal(got[k], v) if isinstance(v, np.ndarray) else got[k] == v, (run, k)
        assert "warm hit" not in printed[run]
    assert not dist.is_initialized() and not launched()
