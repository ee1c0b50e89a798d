"""Ranks of one `torch.distributed` group on this machine, kept for many
calls.

`RankPool(world_size, backend)` starts `world_size` worker processes
(`python -m ggnn_tpu_torch.parallel.launch`), each a rank of one process
group over `tcp://localhost`, and `pool.run(fn, *args)` runs `fn(*args)`
in every rank and returns the ranks' results in rank order. `fn` is sent
by its import path, so it lives in a module the workers can import
(`python_path` adds directories to theirs), and its arguments and result
are pickled. A rank that raises stops the pool (every worker is killed:
its peers would wait in a collective) and `run` raises `RankError` with
that rank's traceback. One pool serves many checks, so the ranks import
torch and load the kernels once. `close()`, or leaving the `with`,
stops every worker.
"""

import datetime
import os
import secrets
import socket
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import Client, Listener, wait
from typing import Any, List, Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class RankError(RuntimeError):
    """A rank of a `RankPool` raised; the message holds its traceback."""


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankPool:
    def __init__(self, world_size: int, backend: str, *,
                 python_path: Sequence[str] = (), timeout: float = 600.0,
                 env: dict = None):
        self.world_size = world_size
        self.timeout = timeout
        authkey = secrets.token_bytes(16)
        self._listener = Listener(("localhost", 0), authkey=authkey)
        host, port = self._listener.address
        child_env = dict(os.environ if env is None else env)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [_REPO, *python_path] + ([child_env["PYTHONPATH"]]
                                     if child_env.get("PYTHONPATH") else []))
        dist_port = free_port()
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "ggnn_tpu_torch.parallel.launch", host,
             str(port), authkey.hex(), str(rank), str(world_size), backend,
             str(dist_port), str(timeout)], env=child_env)
            for rank in range(world_size)]
        self._conns = [None] * world_size
        accepting = threading.Thread(target=self._accept, daemon=True)
        accepting.start()
        accepting.join(timeout)
        if accepting.is_alive() or None in self._conns:
            self.close(kill=True)   # closing the listener ends the accept
            accepting.join()
            raise RankError(f"not every rank connected in {timeout} s")

    def _accept(self) -> None:
        try:
            for _ in range(self.world_size):
                conn = self._listener.accept()
                self._conns[conn.recv()] = conn
        except OSError:
            pass

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.poll() is None
                                         for p in self._procs)

    def run(self, fn, *args, **kwargs) -> List[Any]:
        """`fn(*args, **kwargs)` in every rank; the results by rank."""
        if not self.alive:
            raise RankError("the rank pool has stopped")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        results, pending = [None] * self.world_size, set(range(
            self.world_size))
        deadline = time.monotonic() + self.timeout
        while pending:
            ready = wait([self._conns[r] for r in pending],
                         max(0.0, deadline - time.monotonic()))
            if not ready:
                self.close(kill=True)
                raise RankError(f"ranks {sorted(pending)} gave no result "
                                f"in {self.timeout} s")
            for conn in ready:
                rank = self._conns.index(conn)
                try:
                    status, value = conn.recv()
                except EOFError:
                    self.close(kill=True)
                    raise RankError(f"rank {rank} exited") from None
                if status != "ok":
                    self.close(kill=True)
                    raise RankError(f"rank {rank} raised:\n{value}")
                results[rank] = value
                pending.discard(rank)
        return results

    def close(self, kill: bool = False) -> None:
        """Stop every worker: ask, then kill what has not exited (`kill`:
        kill at once, as after a rank's failure, when its peers may wait
        in a collective)."""
        for conn in self._conns:
            if conn is not None and not kill:
                try:
                    conn.send(None)
                except OSError:
                    pass
        for p in self._procs:
            if kill:
                p.kill()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for conn in self._conns:
            if conn is not None:
                conn.close()
        self._procs, self._conns = [], [None] * self.world_size
        self._listener.close()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _serve(host, port, authkey_hex, rank, world_size, backend, dist_port,
           timeout) -> None:
    import torch.distributed as dist

    from ggnn_tpu_torch.parallel.mesh import initialize_distributed
    conn = Client((host, int(port)), authkey=bytes.fromhex(authkey_hex))
    conn.send(int(rank))
    initialize_distributed(
        backend, init_method=f"tcp://localhost:{dist_port}",
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        while True:
            try:
                task = conn.recv()
            except EOFError:
                break
            except Exception:
                # A task this process cannot unpickle (a function of a
                # module it cannot import, such as a script's __main__).
                conn.send(("error", traceback.format_exc()))
                continue
            if task is None:
                break
            fn, args, kwargs = task
            try:
                reply = ("ok", fn(*args, **kwargs))
            except Exception:
                reply = ("error", traceback.format_exc())
            conn.send(reply)
    finally:
        dist.destroy_process_group()
        conn.close()


if __name__ == "__main__":
    _serve(*sys.argv[1:])
