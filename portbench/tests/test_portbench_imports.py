"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or the JAX package (compared whole: the port's name begins with the JAX
package's), and the plain reference loads nothing of the port."""

from __future__ import annotations

import json

from portbench.tests.conftest import run_in
from portbench.tests.tiny import REPO

RUN = """
import json, sys
from portbench import run, harness as H
rc = run.run(["--workload", "serve.frcnn_hrnet.dense_b8", "--seed", "3",
              "--seconds", "0.5"], device="cpu")
for cell in ("train.hrnet_w32.b32", "extract.hrnet_w32.flip_b32"):
    rc |= run.run(["--workload", cell, "--seed", "3", "--seconds", "0.5"],
                  device="cpu")
print(json.dumps({"rc": rc, "bad": H.forbidden_modules()}))
"""

REFERENCE = """
import json, sys
import portbench.reference.judge, portbench.reference.train
import portbench.flops, portbench.readers, portbench.harness
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_runs_load_no_jax(tiny_root):
    rc, out, err = run_in(tiny_root, RUN)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res == {"rc": 0, "bad": []}


def test_reference_loads_nothing_of_the_port():
    rc, out, err = run_in(REPO, REFERENCE)
    assert rc == 0, err[-3000:]
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & {"stlpose_tpu_torch", "stlpose_tpu", "jax", "jaxlib",
                      "flax"}
