"""Launching the port's rank workers for the multi-process CPU tests.

A test module writes its worker script to a temporary directory and runs
it once, as W processes on a gloo group over a free localhost port
(``launch``). Workers import no jax: they cap torch's threads with
``tests/torch_threads.py`` and write their results with ``torch.save``
to ``<out>/rank<r>.pt``, which the test process reads (``results``).
"""

import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the first lines of every worker: argv = rank, world, port, out dir; the
# group up on gloo; torch capped to one thread
PRELUDE = """
import os, sys
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
sys.path.insert(0, {repo!r})
import tests.torch_threads  # noqa: F401
import numpy as np
import torch
from stlpose_tpu_torch.parallel.distributed import initialize_distributed
initialize_distributed(f"127.0.0.1:{{port}}", world, rank, backend="gloo")


def save(obj):
    assert "jax" not in sys.modules and "stlpose_tpu" not in sys.modules
    torch.save(obj, os.path.join(out, f"rank{{rank}}.pt"))
    print(f"rank{{rank}} OK", flush=True)
""".format(repo=REPO)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(tmp_dir, body: str, world: int = 2, timeout: float = 300,
           env: dict | None = None):
    """Run ``PRELUDE + body`` as ``world`` ranks; returns each rank's
    output. Fails, after killing every rank, if one exits non-zero or the
    run outlasts ``timeout`` seconds."""
    script = os.path.join(str(tmp_dir), "rank_worker.py")
    with open(script, "w") as f:
        f.write(PRELUDE + body)
    out_dir = os.path.join(str(tmp_dir), "ranks")
    os.makedirs(out_dir, exist_ok=True)
    port = str(free_port())
    full_env = {k: v for k, v in os.environ.items()
                if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                             "MASTER_ADDR", "MASTER_PORT")}
    full_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), port, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=full_env,
        text=True, cwd=REPO) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank{r} OK" in out, \
            f"rank {r} failed:\n{out[-6000:]}"
    return outs


def results(tmp_dir, world: int = 2):
    """Each rank's saved results, in rank order."""
    return [torch.load(os.path.join(str(tmp_dir), "ranks", f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
