"""Worlds of gloo processes on the CPU for the port's tests of
``em_adapt_torch/parallel/``.

:func:`run_world` starts ``n`` fresh processes that join one gloo group
through a FileStore under the test's ``tmp_path`` and run a worker
function of a test module, by name, on a pickled payload; the parent kills
them after a timeout of their own, so a hung rendezvous fails one test.
"""

import importlib
import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(module: str, worker: str, n: int, payload, tmp_path,
              timeout: float = 120.0) -> list:
    """Run ``module.worker(world, payload)`` in ``n`` processes that form a
    gloo world on the CPU; return their results by rank. Raises with the
    processes' output when one fails or they are not done within
    ``timeout`` seconds (all are then killed)."""
    work = tmp_path / f"world-{worker}-{time.monotonic_ns()}"
    work.mkdir()
    with open(work / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    code = "from tests.torch_world import _child; _child()"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), str(n), str(work), module,
                               worker], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
            raise AssertionError(f"world {worker} not done in {timeout} s:\n" + "\n".join(outs))
    if any(p.returncode for p in procs):
        raise AssertionError(f"world {worker}: exit codes {[p.returncode for p in procs]}\n"
                             + "\n".join(outs))
    results = []
    for rank in range(n):
        with open(work / f"out{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _child() -> None:
    """One process of :func:`run_world`: argv = rank, n, workdir, module, worker."""
    import torch

    from em_adapt_torch.parallel.mesh import init_world

    rank, n, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    fn = getattr(importlib.import_module(sys.argv[4]), sys.argv[5])
    torch.set_num_threads(2)
    with open(os.path.join(work, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    world = init_world("cpu", coordinator=f"file://{work}/store", num_processes=n,
                       process_id=rank, timeout=60)
    try:
        out = fn(world, payload)
    finally:
        world.close()
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
