"""The port's rolling-restart supervisor (captionax_torch/decode/supervise.py)
on the CPU: tests/test_supervise.py's hitless handover with a stub worker
that imports the port's ``run_worker``.  The RSS limit sits far below a
Python process's baseline, so the supervisor rolls the worker continuously
while 8 client threads post; >= 2 handovers must happen with zero client
errors.  Also ``proc_rss_mb`` against /proc and the standby protocol."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

from captionax_torch.decode import supervise
from captionax_torch.decode.supervise import READY_MARK, RssSupervisor, proc_rss_mb

STUB = '''
import argparse
import sys
import time

sys.path.insert(0, {pkg!r})

p = argparse.ArgumentParser()
p.add_argument("--listen-fd", type=int, default=-1)
p.add_argument("--standby", action="store_true")
a = p.parse_args()

from captionax_torch.decode.supervise import run_worker


class Dummy:
    styles = ["factual"]
    decode = "greedy"

    def stats(self):
        return {{"served": 0}}

    def caption_bytes(self, data, style):
        time.sleep(0.02)
        return {{"caption": "ok", "style": style}}

    def close(self):
        pass


run_worker(Dummy(), "127.0.0.1", 0, drain_grace_s=1.0,
           listen_fd=a.listen_fd if a.listen_fd >= 0 else None,
           standby=a.standby)
'''

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stub(tmp_path):
    stub = tmp_path / "worker_stub.py"
    stub.write_text(STUB.format(pkg=PKG_ROOT))
    return stub


def test_hitless_rolling_restart(tmp_path):
    sup = RssSupervisor([sys.executable, str(_stub(tmp_path))], rss_limit_mb=20.0,
                        poll_s=0.3, listen_port=0, prearm_frac=0.8,
                        exit_grace_s=15.0, ready_timeout_s=120.0)
    assert sup.port, "supervisor must own the bound port"
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()

    stop = threading.Event()
    errors, served = [], []
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            req = urllib.request.Request(
                f"http://127.0.0.1:{sup.port}/caption?style=factual",
                data=b"x", headers={"Content-Type": "image/jpeg"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    out = json.loads(r.read())
                with lock:
                    served.append(out["caption"])
            except Exception as e:  # noqa: BLE001 — every error counts
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, daemon=True) for _ in range(8)]
    for th in threads:
        th.start()
    deadline = time.time() + 60
    while time.time() < deadline and sup.recycles < 2:
        time.sleep(0.5)
    stop.set()
    for th in threads:
        th.join(timeout=30)
    sup.stop()
    t.join(timeout=60)

    assert not t.is_alive() and not any(th.is_alive() for th in threads)
    assert sup.recycles >= 2, f"expected >=2 recycles, got {sup.recycles}"
    assert not errors, f"hitless handover violated: {errors[:5]}"
    assert len(served) > 10 and set(served) == {"ok"}
    assert sup.current.poll() is not None, "the last worker was not retired"


def test_proc_rss_mb():
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    got = proc_rss_mb(os.getpid())
    assert got is not None and abs(got - kb / 1024.0) < 64
    assert proc_rss_mb(2 ** 22 + 12345) is None  # no such process


def test_standby_worker_waits_for_sigusr1(tmp_path):
    """A standby worker prints its ready mark without serving, and SIGTERM
    before SIGUSR1 retires it unused."""
    import signal
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    proc = subprocess.Popen(
        [sys.executable, str(_stub(tmp_path)), "--listen-fd", str(sock.fileno()), "--standby"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, pass_fds=(sock.fileno(),))
    try:
        line = proc.stdout.readline()
        assert READY_MARK in line and "standby=1" in line
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=30)[0]
        assert "retired unused" in out and proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        sock.close()


def test_spawn_puts_the_repo_on_pythonpath(tmp_path, monkeypatch):
    """A worker started from elsewhere imports the port from the checkout."""
    seen = {}
    real = subprocess.Popen

    def popen(argv, **kw):
        seen["env"] = kw["env"]
        return real(argv, **kw)

    monkeypatch.setattr(supervise.subprocess, "Popen", popen)
    sup = RssSupervisor([sys.executable, str(_stub(tmp_path))], rss_limit_mb=1e6,
                        listen_port=0, ready_timeout_s=120.0, exit_grace_s=15.0)
    proc = sup._spawn()
    try:
        assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == PKG_ROOT
    finally:
        sup._retire(proc)
        sup._sock.close()
    assert proc.poll() is not None
