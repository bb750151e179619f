"""The PyTorch port imports neither JAX nor the JAX package: the machine
with the card has no JAX. Checked in a fresh interpreter, since this test
process already holds JAX."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import cytvdn_tpu_torch
import cytvdn_tpu_torch.kernels, cytvdn_tpu_torch.kernels.build
import cytvdn_tpu_torch.kernels.resident
import cytvdn_tpu_torch.solver, cytvdn_tpu_torch.utils.state
import cytvdn_tpu_torch.utils.perf
leaked = {'jax', 'jaxlib', 'cytvdn_tpu'} & {m.split('.')[0] for m in sys.modules}
assert not leaked, leaked
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
