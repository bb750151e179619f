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
import cytvdn_tpu_torch.api, cytvdn_tpu_torch.solver.engine
import cytvdn_tpu_torch.utils.checkpoint, cytvdn_tpu_torch.utils.log
import cytvdn_tpu_torch.cli, cytvdn_tpu_torch.presets
import cytvdn_tpu_torch.io, cytvdn_tpu_torch.io.dm, cytvdn_tpu_torch.io.emd
import cytvdn_tpu_torch.io.loaders
import cytvdn_tpu_torch.solver.outofcore
import cytvdn_tpu_torch.parallel, cytvdn_tpu_torch.parallel.api
import cytvdn_tpu_torch.parallel.distributed, cytvdn_tpu_torch.parallel.halo
import cytvdn_tpu_torch.parallel.multihost
import cytvdn_tpu_torch.parallel.partition
import cytvdn_tpu_torch.parallel.sharded, cytvdn_tpu_torch.parallel.pairfix
import cytvdn_tpu_torch.cpp, cytvdn_tpu_torch.cpp.backend
import cytvdn_tpu_torch.cpp.build
leaked = {'jax', 'jaxlib', 'cytvdn_tpu'} & {m.split('.')[0] for m in sys.modules}
assert not leaked, leaked
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ``python -m cytvdn_tpu_torch.cli ARGS`` in this interpreter, then the probe
CLI_PROBE = """
import runpy, sys
sys.argv = ["cytv-torch"] + sys.argv[1:]
try:
    runpy.run_module("cytvdn_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
leaked = {'jax', 'jaxlib', 'cytvdn_tpu'} & {m.split('.')[0] for m in sys.modules}
assert not leaked, leaked
"""


@pytest.mark.parametrize("run", ["help", "solve", "cpp"])
def test_cli_imports_no_jax(tmp_path, run):
    """The command, asked for its help or run end to end (on the CPU, or
    through the C++ host kernels, whose library the port builds under its
    own ``_build/``; a .dm4 input, an EMD output), loads neither JAX nor
    the JAX package."""
    import numpy as np

    from cytvdn_tpu_torch.io.dm import write_dm

    if run == "help":
        args = ["--help"]
    else:
        inp = str(tmp_path / "in.dm4")
        write_dm(inp, np.ones((4, 5, 6), np.float32))
        args = ["-i", inp, "-o", str(tmp_path / "out.emd"), "-m", "1.0",
                "-n", "3", "-f", "1"]
        args += ["--backend", "cpp"] if run == "cpp" else ["--device", "cpu"]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", CLI_PROBE, *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    if run == "help":
        assert proc.stdout.startswith("usage: cytv-torch")
    else:
        assert os.path.exists(str(tmp_path / "out.emd"))
    if run == "cpp":
        assert os.path.exists(os.path.join(
            REPO, "cytvdn_tpu_torch", "_build", "libtvdn_cpu.so"))
