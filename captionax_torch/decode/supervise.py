"""Rolling restarts of a serving worker with a hitless handover.

Port of ``captionax/decode/supervise.py``, unchanged in behaviour.  A long
running server process is recycled when its host RSS crosses a bound; the
handover loses no request:

- the SUPERVISOR owns the listening socket (bound and listening once) and
  passes its fd to every worker generation (``pass_fds``), so all workers
  accept from the SAME kernel accept queue.  A retiring worker that stops
  accepting strands no queued connection: the survivor accepts it.
  (SO_REUSEPORT would give each worker its own accept queue, and Linux
  resets whatever sits in a queue when its socket closes.)
- the WORKER serves HTTP on the inherited fd and exits gracefully on
  SIGTERM (stop accepting, drain in-flight handler threads, close);
- the supervisor watches the worker's RSS via ``/proc/<pid>/status``.
  At ``prearm_frac * rss_limit_mb`` it starts the REPLACEMENT in the
  background, as a standby that builds its model, warms up and then
  accepts nothing until SIGUSR1; when the incumbent crosses
  ``rss_limit_mb`` the switch is immediate.

On the card each worker is a process with its own CUDA context, its own
copy of the model and the encoder on the card, and the kernel library
loaded from ``captionax_torch/_build/``; while a standby is pre-armed, two
such processes share the card.  ``python -m captionax_torch.cli.serve
--rss-limit-mb <MB> --port <p>`` runs the server under this supervisor.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

READY_MARK = "WORKER_READY"


def proc_rss_mb(pid: int) -> Optional[float]:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


def run_worker(service, host: str, port: int, *,
               drain_grace_s: float = 10.0, warmup=None,
               listen_fd: Optional[int] = None,
               standby: bool = False) -> None:
    """Serve ``service`` on (host, port) — or on the supervisor's
    inherited ``listen_fd`` — with graceful SIGTERM drain.  Prints
    ``WORKER_READY port=<p>`` only after the optional ``warmup()`` ran
    (its first decode paid before a request can arrive).  Blocks until
    SIGTERM.

    ``standby=True`` (pre-armed replacements): after warmup the worker
    does NOT accept — it idles fully hot until SIGUSR1 activates it, so
    an idle standby serves no traffic and its RSS does not grow with the
    incumbent's while it waits.  If it is retired unused (SIGTERM before
    SIGUSR1) it closes without serving."""
    from captionax_torch.decode.service import make_http_server

    if warmup is not None:
        warmup(service)
    srv = make_http_server(service, host, port,
                           reuse_port=listen_fd is None,
                           listen_fd=listen_fd)
    stop = threading.Event()
    go = threading.Event()

    def on_term(signum, frame):
        stop.set()

    def on_activate(signum, frame):
        go.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGUSR1, on_activate)
    if standby:
        print(f"{READY_MARK} port={srv.server_address[1]} "
              f"pid={os.getpid()} standby=1", flush=True)
        while not (go.is_set() or stop.is_set()):
            time.sleep(0.1)
        if stop.is_set() and not go.is_set():
            srv.server_close()
            service.close()
            print(f"standby worker {os.getpid()} retired unused",
                  flush=True)
            return
        print(f"worker {os.getpid()} activated", flush=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    if not standby:
        print(f"{READY_MARK} port={srv.server_address[1]} pid={os.getpid()}",
              flush=True)
    while not stop.wait(0.5):
        pass
    # graceful drain: stop accepting (with a shared listen_fd the queued
    # connections remain in the shared queue for the survivor), let
    # in-flight handler threads finish, then release the device plumbing
    srv.shutdown()
    srv.server_close()
    time.sleep(drain_grace_s)
    service.close()
    print(f"worker {os.getpid()} drained and exiting", flush=True)


class RssSupervisor:
    """Spawn/monitor/recycle a serving worker subprocess.

    ``worker_argv`` must start a process that prints ``WORKER_READY``
    once it is serving and exits on SIGTERM (see :func:`run_worker`).

    ``listen_port`` >= 0 turns on the shared-listener handover: the
    supervisor binds (listen_host, listen_port) itself and appends
    ``--listen-fd <fd>`` to each worker's argv (inherited via
    ``pass_fds``).  ``listen_port=None`` keeps the legacy mode where
    workers bind the port themselves with SO_REUSEPORT.
    """

    def __init__(self, worker_argv: List[str], rss_limit_mb: float, *,
                 poll_s: float = 2.0, ready_timeout_s: float = 1800.0,
                 exit_grace_s: float = 120.0,
                 listen_host: str = "127.0.0.1",
                 listen_port: Optional[int] = None,
                 prearm_frac: float = 0.8):
        self.worker_argv = list(worker_argv)
        self.rss_limit_mb = float(rss_limit_mb)
        self.poll_s = poll_s
        self.ready_timeout_s = ready_timeout_s
        self.exit_grace_s = exit_grace_s
        self.prearm_frac = prearm_frac
        self.recycles = 0
        self.current: Optional[subprocess.Popen] = None
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self.port: Optional[int] = None
        if listen_port is not None:
            self._sock = socket.socket()
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((listen_host, listen_port))
            self._sock.listen(128)
            self.port = self._sock.getsockname()[1]
        # replacement being prepared ahead of the limit (pre-arm)
        self._pending: Optional[subprocess.Popen] = None
        self._pending_thread: Optional[threading.Thread] = None
        self._pending_err: Optional[BaseException] = None

    def _spawn(self, standby: bool = False) -> subprocess.Popen:
        # the port may be run from a checkout rather than installed:
        # make sure the worker can import it wherever the supervisor
        # was launched from
        env = os.environ.copy()
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        argv = list(self.worker_argv)
        pass_fds = ()
        if self._sock is not None:
            argv += ["--listen-fd", str(self._sock.fileno())]
            pass_fds = (self._sock.fileno(),)
        if standby:
            argv += ["--standby"]
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1, env=env,
            pass_fds=pass_fds,
        )
        ready = threading.Event()

        def pump():
            for line in proc.stdout:  # tee worker logs + catch READY
                sys.stdout.write(f"[worker {proc.pid}] {line}")
                sys.stdout.flush()
                if READY_MARK in line:
                    ready.set()
            # EOF: worker exited; unblock any waiter
            ready.set()

        threading.Thread(target=pump, daemon=True).start()
        deadline = time.time() + self.ready_timeout_s
        while not ready.is_set():
            if time.time() > deadline or proc.poll() is not None:
                proc.kill()
                raise RuntimeError(
                    f"worker {proc.pid} failed to become ready "
                    f"(exit={proc.poll()})")
            time.sleep(0.2)
        if proc.poll() is not None:
            raise RuntimeError(f"worker exited immediately ({proc.poll()})")
        return proc

    def _start_prearm(self):
        """Kick off a STANDBY replacement spawn in the background: model
        build + warmup run while the incumbent still has RSS headroom,
        then the replacement idles hot (it accepts nothing until
        activated, see run_worker standby)."""
        if self._pending_thread is not None:
            return

        def build():
            try:
                self._pending = self._spawn(standby=self._sock is not None)
            except BaseException as e:  # surfaced at switch time
                self._pending_err = e

        self._pending_thread = threading.Thread(target=build, daemon=True)
        self._pending_thread.start()

    def _activate(self, proc: subprocess.Popen) -> None:
        """Tell a standby worker to start accepting (no-op for legacy
        non-standby replacements, which already serve)."""
        if self._sock is not None and proc.poll() is None:
            proc.send_signal(signal.SIGUSR1)

    def _take_pending(self, block: bool) -> Optional[subprocess.Popen]:
        if self._pending_thread is None:
            return None
        if block:
            self._pending_thread.join()
        if self._pending_thread.is_alive():
            return None
        self._pending_thread = None
        if self._pending_err is not None:
            err, self._pending_err = self._pending_err, None
            raise err
        proc, self._pending = self._pending, None
        return proc

    def _retire(self, proc: subprocess.Popen) -> None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=self.exit_grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()

    def stop(self):
        self._stop.set()

    def run(self) -> None:
        """Monitor loop; blocks until :meth:`stop` (or KeyboardInterrupt),
        then retires the live worker."""
        self.current = self._spawn()
        try:
            while not self._stop.wait(self.poll_s):
                if self.current.poll() is not None:
                    print(f"worker died (exit={self.current.poll()}); "
                          "respawning", flush=True)
                    pend = self._take_pending(block=True)
                    if pend is not None:
                        self._activate(pend)
                        self.current = pend
                    else:
                        self.current = self._spawn()
                    self.recycles += 1
                    continue
                rss = proc_rss_mb(self.current.pid)
                if rss is None:
                    continue
                if rss > self.prearm_frac * self.rss_limit_mb:
                    self._start_prearm()
                if rss > self.rss_limit_mb:
                    replacement = self._take_pending(
                        block=rss > self.rss_limit_mb * 1.05)
                    if replacement is None:
                        continue  # pre-arm still compiling; next poll
                    print(f"worker {self.current.pid} rss {rss:.0f} MB > "
                          f"limit {self.rss_limit_mb:.0f} MB; rolling",
                          flush=True)
                    old = self.current
                    self._activate(replacement)  # hot standby -> serving
                    self.current = replacement
                    self._retire(old)
                    self.recycles += 1
        except KeyboardInterrupt:
            pass
        finally:
            if self.current is not None and self.current.poll() is None:
                self._retire(self.current)
            pend = None
            try:
                pend = self._take_pending(block=True)
            except BaseException:
                pass
            if pend is not None and pend.poll() is None:
                self._retire(pend)
            if self._sock is not None:
                self._sock.close()
