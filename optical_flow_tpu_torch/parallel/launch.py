"""Run a function in several processes, one a rank (the multi-process runs of ``parallel/mesh.py``).

    results = run_ranks(fn, world_size, args, timeout=120.0)

Each rank is a fresh ``spawn``-ed Python process calling
``fn(rank, world_size, *args)``; ``fn`` must be importable by name (a
module-level function) and joins the run itself with
``parallel.mesh.initialize_distributed``, whose rendezvous address it gets
in ``args`` (:func:`free_tcp_address`, or a ``file://`` path).  The return
values come back in rank order.  If any rank raises, or the run outlives
``timeout`` seconds, every process is stopped and :class:`RanksFailed`
carries each rank's traceback.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback


class RanksFailed(RuntimeError):
    """A rank raised, died or outlived the run's time limit."""


def free_tcp_address() -> str:
    """A ``tcp://127.0.0.1:<port>`` rendezvous on a port free just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _rank_main(fn, rank, world_size, args, results):
    from optical_flow_tpu_torch.parallel.mesh import shutdown_distributed

    try:
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown_distributed()


def run_ranks(fn, world_size: int, args=(), timeout: float = 120.0) -> list:
    """``[fn(rank, world_size, *args) for rank in range(world_size)]``, each in its own process."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, args, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, errors = {}, {}
    try:
        while len(out) + len(errors) < world_size:
            try:
                rank, ok, value = results.get(timeout=max(0.1, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in errors]
                for r in dead:
                    errors[r] = f"rank {r} exited with code {procs[r].exitcode}"
                if dead or time.monotonic() > deadline:
                    break
                continue
            (out if ok else errors)[rank] = value
            if errors:
                break
    finally:
        if errors or len(out) < world_size:
            for p in procs:
                p.kill()
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if errors or len(out) < world_size:
        late = [r for r in range(world_size) if r not in out and r not in errors]
        msg = "".join(f"\n--- rank {r} ---\n{e}" for r, e in sorted(errors.items()))
        if late:
            msg += f"\nranks {late} gave no result within {timeout:.0f} s"
        raise RanksFailed(f"{len(errors) + len(late)} of {world_size} ranks failed:{msg}")
    return [out[r] for r in range(world_size)]
