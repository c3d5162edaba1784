"""Run one function on N rank processes of one host and collect what each
returns: the port's counterpart of the JAX tests' ``run_multidevice`` and
of the serving sweep's subprocess loop.

``run_ranks("package.module:function", n, args)`` starts ``n`` Python
processes; each sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and
``LOCAL_WORLD_SIZE``, keeps torch to one thread, starts the default process
group (NCCL for ``device="cuda"``, the default, one card per rank;
gloo for ``cpu``) over a ``file://``
store in a temporary directory — so concurrent jobs never contend for a
port — calls ``function(*args)`` and pickles its result back.  The function
must be importable by name in a fresh interpreter: the children get the
parent's ``sys.path``.
Any rank that fails, or a run past ``timeout`` seconds, raises with the
output of every rank that failed (or, past the timeout, of every rank);
the ranks still running then are stopped, and none outlives
``run_ranks``.  A rank that returns waits at a barrier for the others,
then leaves without the interpreter's teardown (``os._exit``): a process
group's threads torn down at exit have aborted a finished rank.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Sequence

_SRC = str(Path(__file__).resolve().parents[2])


class RankFailure(RuntimeError):
    """A rank exited with an error or the run timed out."""


def run_ranks(target: str, n: int, args: Sequence[Any] = (), *,
              device: str = "cuda", timeout: float = 600.0) -> List[Any]:
    """``target(*args)`` on ``n`` ranks; returns each rank's result, in rank
    order.  ``device`` is ``cuda`` (the default: NCCL, one card per rank;
    raises before any rank starts where the host has fewer cards than
    ranks, and nothing drops to the CPU) or ``cpu`` (gloo)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    backend = "nccl" if device.startswith("cuda") else "gloo"
    if backend == "nccl":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"run_ranks on device {device!r} needs one CUDA device per "
                f"rank: {n} ranks, {have} devices (device='cpu' runs gloo "
                f"ranks on the CPU)")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        tmp = Path(tmp)
        spec = tmp / "spec.pkl"
        with open(spec, "wb") as f:
            pickle.dump({"target": target, "args": tuple(args),
                         "sys_path": list(sys.path), "backend": backend,
                         "init_method": f"file://{tmp / 'store'}"}, f)
        env = dict(os.environ)
        env.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [_SRC] + [p for p in env.get("PYTHONPATH", "").split(
                           os.pathsep) if p]))
        procs, logs = [], []
        timed_out, stopped = False, set()
        try:
            for r in range(n):
                log = open(tmp / f"rank{r}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.ranks",
                     str(spec), str(r)],
                    stdout=log, stderr=subprocess.STDOUT,
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break  # one rank failed: the others would wait forever
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for r, p in enumerate(procs):
                if p.poll() is None:
                    stopped.add(r)
                    p.kill()
                p.wait()
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(log.read())
            log.close()
        bad = [r for r, p in enumerate(procs)
               if p.returncode != 0 and (timed_out or r not in stopped)]
        if bad:
            raise RankFailure(
                f"{target} on {n} ranks: "
                + (f"timed out after {timeout} s" if timed_out
                   else f"ranks {bad} failed (stopped: {sorted(stopped)})")
                + "".join(f"\n--- rank {r} (exit {procs[r].returncode}) ---\n"
                          f"{out[r]}" for r in bad))
        results = []
        for r in range(n):
            with open(tmp / f"result{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def _child(spec_path: str, rank: int) -> None:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    for p in spec["sys_path"]:
        if p not in sys.path:
            sys.path.append(p)
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if spec["backend"] == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(spec["backend"], init_method=spec["init_method"],
                            rank=rank, world_size=int(os.environ["WORLD_SIZE"]))
    mod, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(mod), name)
    result = fn(*spec["args"])  # an exception exits 1 with its traceback
    with open(Path(spec_path).parent / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
