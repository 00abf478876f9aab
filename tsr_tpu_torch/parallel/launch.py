"""Start ranks: the entry of every rank the port starts itself.

:func:`spawn` runs a function on ``n`` ranks, each a fresh interpreter
(``torch.multiprocessing``, the *spawn* method) joined into one group over
``env://`` on a free localhost port, and returns each rank's result. A rank
that fails ends the others (no rank waits on a dead one) and the call
raises; every rendezvous and collective also has
``distributed.TIMEOUT_S``. The scripts' ``--mesh`` starts its ranks here
(:func:`run_script`) unless it already runs under torchrun.
"""

from __future__ import annotations

import os
import pickle
import runpy
import shutil
import socket
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch

from tsr_tpu_torch.parallel import distributed

# seconds a command's ranks (``--mesh`` without torchrun) may run in all
SCRIPT_TIMEOUT_S = 86400.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def in_torchrun_env() -> bool:
    """True when torchrun's variables name this process's rank."""
    return all(os.environ.get(k) is not None
               for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _rank_entry(rank, world, port, device, fn, args, out_dir, threads):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    if rank:
        sys.stdout = open(os.devnull, "w")
    distributed.initialize(device=device)
    try:
        result = fn(*args)
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *, device: str,
          timeout: float = 900.0, threads: Optional[int] = None) -> List:
    """Run ``fn(*args)`` on ``nprocs`` ranks joined into one group and
    return their results in rank order (each pickled back through a
    temporary directory). ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). ``device`` (``"cuda"`` or ``"cpu"``, no
    default) picks each rank's device and backend
    (``distributed.rank_placement``); ``threads`` sets each rank's CPU
    threads (default: the host's cores shared out, unless
    ``OMP_NUM_THREADS`` is set). Every rank but 0 writes no standard
    output. Raises when a rank fails (the
    others are ended) or when ``timeout`` seconds pass."""
    import torch.multiprocessing as mp

    if threads is None and "OMP_NUM_THREADS" not in os.environ:
        threads = max(1, (os.cpu_count() or 1) // nprocs)
    out_dir = tempfile.mkdtemp(prefix="tsr_ranks_")
    ctx = mp.start_processes(
        _rank_entry, args=(nprocs, free_port(), device, fn, tuple(args),
                           out_dir, threads),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} ran "
                                   f"past {timeout:.0f} s")
        results = []
        for rank in range(nprocs):
            with open(os.path.join(out_dir, f"{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(out_dir, ignore_errors=True)


def _run_script(script: str, argv: List[str]) -> None:
    runpy.run_path(script, run_name="__tsr_rank__")["main"](argv)


def run_script(script: str, argv: Sequence[str], nprocs: int,
               device: str) -> int:
    """Run a numbered script's ``main(argv)`` on ``nprocs`` ranks of
    ``device`` (``--mesh`` without torchrun). Returns 0, or 1 after
    printing why a rank failed."""
    try:
        spawn(_run_script, nprocs, (str(script), list(argv)), device=device,
              timeout=SCRIPT_TIMEOUT_S)
    except Exception as e:  # a rank's traceback is in the message
        print(f"--mesh: a rank failed: {e}", file=sys.stderr)
        return 1
    return 0
